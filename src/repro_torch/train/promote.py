"""Train→deploy promotion: the training step, the integer bundle and its
on-disk format.

Port of ``repro/train/promote.py``.  The deployment artifact is the
``core.fixed_point.IntKwsBundle``: int8 weight codes, int32 bias codes on
the accumulator grid, the static ``GruFormats``/``FexFormats`` and the
deployment Δ_TH.

  * ``make_kws_step_fn`` — the (QAT) training step shared by
    ``launch.train --arch deltakws`` and ``launch.serve --train-steps``:
    autograd through the eager ΔGRU loop, then AdamW;
  * ``eval_promotion`` — float vs promoted-int8 accuracy on a held-out
    synthetic batch, through the serving kernels on a CUDA device;
  * ``promote`` — the pure fold of a float parameter dict (re-export of
    ``fixed_point.promote_kws``); ``promote_checkpoint`` applies it to a
    checkpoint directory;
  * ``save_bundle``/``load_bundle`` — one .npz of integer code arrays
    plus a JSON metadata record, entry for entry the reference's layout:
    a bundle the JAX package wrote loads here unchanged, and the JAX
    package loads the port's.
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


def make_kws_step_fn(cfg, ocfg, threshold: float, qat: bool = True, *,
                     frame_level: bool = False):
    """The KWS training step ``(params, opt_state, batch) → (params,
    opt_state, metrics)``: the gradient of ``kws.loss_fn`` (utterance
    labels ``batch["labels"]``) or, with ``frame_level``, of
    ``kws.frame_loss_fn`` (``batch["frame_labels"]``) through the eager
    differentiable ΔGRU, then one ``optimizer.update``.  ``qat`` trains
    the deployed numerics (8-bit STE weights, Q0.15 hidden state), which
    the promotion fold expects.  Nothing is read back to the host: the
    metrics are device tensors."""
    from repro_torch.models import kws
    from repro_torch.train import optimizer as opt
    loss = kws.frame_loss_fn if frame_level else kws.loss_fn

    def step_fn(params, opt_state, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            value, m = loss(leaves, cfg, batch, threshold, qat=qat)
            grads = torch.autograd.grad(value, list(leaves.values()))
        with torch.no_grad():
            params, opt_state, om = opt.update(
                ocfg, dict(zip(leaves, grads)), opt_state, params)
        return params, opt_state, {
            "loss": value.detach(), "acc": m["acc"],
            "sparsity": m["sparsity"], **om}

    return step_fn


def eval_promotion(params, cfg, fex, threshold: float, *, n: int = 256,
                   seed: int = 1234):
    """Promote ``params`` and compare the float and the bit-true int8
    forward's accuracy on a held-out synthetic batch (``synth_batch`` of
    ``default_rng(seed)``, as the reference draws it), on the params'
    device: on a CUDA device the features come from the ``iir_fex``
    kernel, the float forward runs ``delta_gru_seq`` and the int8 forward
    ``delta_gru_seq_int``.  Returns ``(acc_float, acc_int8, bundle)``."""
    from repro_torch.data.gscd import synth_batch
    from repro_torch.models import kws

    dev = params["w_x"].device
    audio, labels = synth_batch(np.random.default_rng(seed), n)
    labels = torch.from_numpy(labels).to(dev)
    with torch.no_grad():
        feats = fex(torch.from_numpy(audio).to(dev))
        logits_f, _ = kws.forward(params, cfg, feats, threshold=threshold,
                                  backend="pallas")
        bundle = fp.promote_kws(params, threshold, fex=fex)
        logits_i, _, _ = fp.int_forward(bundle, feats, backend="pallas")
    acc_f = float((logits_f.argmax(-1) == labels).float().mean())
    acc_i = float((logits_i.argmax(-1) == labels).float().mean())
    return acc_f, acc_i, bundle


def promote_checkpoint(ckpt_dir: str | pathlib.Path, cfg,
                       threshold: float, fex=None,
                       step: int | None = None) -> fp.IntKwsBundle:
    """Fold the newest (or ``step``-th) checkpoint — the port's or the
    JAX package's — into an IntKwsBundle."""
    from repro_torch.models import kws
    from repro_torch.train import checkpoint as ckpt

    step = ckpt.latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    input_dim = fex.cfg.n_active if fex is not None else 10
    like = kws.init_kws(torch.Generator().manual_seed(0), cfg,
                        input_dim=input_dim)
    state = ckpt.restore(ckpt_dir, step, {"params": like})
    return fp.promote_kws(state["params"], threshold, fex=fex)


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
