"""Train→deploy promotion: the integer bundle and its on-disk format.

Port of the deployment half of ``repro/train/promote.py``.  The
deployment artifact is the ``core.fixed_point.IntKwsBundle``: int8 weight
codes, int32 bias codes on the accumulator grid, the static
``GruFormats``/``FexFormats`` and the deployment Δ_TH.

  * ``promote`` — the pure fold of a float parameter dict (re-export of
    ``fixed_point.promote_kws``);
  * ``save_bundle``/``load_bundle`` — one .npz of integer code arrays
    plus a JSON metadata record, entry for entry the reference's layout:
    a bundle the JAX package wrote loads here unchanged, and the JAX
    package loads the port's.

Training (the QAT step, ``eval_promotion``, ``promote_checkpoint``) comes
with the training slice of the port (ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from repro_torch.core import fixed_point as fp

promote = fp.promote_kws


def dataclass_dict(dc) -> dict:
    return dataclasses.asdict(dc)


def save_bundle(path: str | pathlib.Path, bundle: fp.IntKwsBundle
                ) -> pathlib.Path:
    """Write the bundle as one .npz (code arrays + JSON meta).  Returns
    the path written: ``np.savez`` appends ".npz" to bare names, so the
    name is normalized first and the returned path always loads back."""
    path = pathlib.Path(path)
    if not path.name.endswith(".npz"):
        path = path.with_name(path.name + ".npz")
    meta = {
        "gfmt": dataclass_dict(bundle.gfmt),
        "ffmt": dataclass_dict(bundle.ffmt) if bundle.ffmt else None,
        "threshold": bundle.threshold,
    }
    arr = lambda t, dt: t.detach().cpu().numpy().astype(dt)
    arrays = {
        "w_x": arr(bundle.gru.w_x, np.int8), "w_h": arr(bundle.gru.w_h,
                                                        np.int8),
        "b": arr(bundle.gru.b, np.int32),
        "w_fc": arr(bundle.w_fc, np.int8), "b_fc": arr(bundle.b_fc,
                                                       np.int32),
        "meta": np.frombuffer(json.dumps(meta).encode(), np.uint8),
    }
    if bundle.coef is not None:
        arrays["coef"] = arr(bundle.coef, np.int32)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)
    return path


def load_bundle(path: str | pathlib.Path) -> fp.IntKwsBundle:
    """Inverse of ``save_bundle`` (and of the reference's): codes and
    formats restore exactly, as CPU tensors."""
    with np.load(pathlib.Path(path)) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        t = lambda k, dt: torch.from_numpy(np.asarray(data[k], dt).copy())
        gru = fp.IntGruWeights(w_x=t("w_x", np.int8), w_h=t("w_h", np.int8),
                               b=t("b", np.int32))
        coef = t("coef", np.int32) if "coef" in data.files else None
        w_fc, b_fc = t("w_fc", np.int8), t("b_fc", np.int32)
    return fp.IntKwsBundle(
        gru=gru, w_fc=w_fc, b_fc=b_fc, gfmt=fp.GruFormats(**meta["gfmt"]),
        threshold=float(meta["threshold"]), coef=coef,
        ffmt=fp.FexFormats(**meta["ffmt"]) if meta["ffmt"] else None)
