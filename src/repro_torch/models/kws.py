"""The paper's model: IIR FEx → ΔGRU(64) → FC(12) keyword spotter.

Inference half of ``repro/models/kws.py`` plus the weight converter
``params_from_numpy``: a parameter tree is a plain dict of float32
tensors ``{"w_x", "w_h", "b", "w_fc", "b_fc"}`` with the JAX package's
names, shapes and layouts, so the same numpy arrays serve in both
packages.
"""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from repro_torch.core import delta_gru as dg

N_CLASSES = 12
CLASSES = ["silence", "unknown", "down", "go", "left", "no",
           "off", "on", "right", "stop", "up", "yes"]
PARAM_KEYS = ("w_x", "w_h", "b", "w_fc", "b_fc")


def init_kws(generator: torch.Generator, cfg, input_dim: int = 10) -> dict:
    """Random weights from ``generator`` (on the generator's device):
    cfg.d_model = GRU width, cfg.vocab_size = FC head width."""
    n_classes = getattr(cfg, "vocab_size", N_CLASSES)
    gru = dg.init_delta_gru(generator, input_dim, cfg.d_model)
    w_fc = torch.randn((cfg.d_model, n_classes), generator=generator,
                       device=generator.device) / np.sqrt(cfg.d_model)
    return {"w_x": gru.w_x, "w_h": gru.w_h, "b": gru.b, "w_fc": w_fc,
            "b_fc": torch.zeros((n_classes,), device=generator.device)}


def params_from_numpy(tree, device="cpu") -> dict:
    """The JAX package's KWS weights → this package's tensors on ``device``.

    ``tree`` maps ``w_x`` (I, 3H), ``w_h`` (H, 3H), ``b`` (3H,),
    ``w_fc`` (H, K), ``b_fc`` (K,) to arrays (``np.asarray`` of
    ``repro.models.kws.init_kws(...)[0]``, or a checkpoint's arrays).
    Raises ``ValueError`` on a missing key or inconsistent shapes.
    """
    missing = [k for k in PARAM_KEYS if k not in tree]
    if missing:
        raise ValueError(f"KWS weights lack {missing} (need {PARAM_KEYS})")
    arr = {k: np.asarray(tree[k], np.float32) for k in PARAM_KEYS}
    H = arr["w_h"].shape[0]
    I = arr["w_x"].shape[0]
    K = arr["b_fc"].shape[0] if arr["b_fc"].ndim == 1 else -1
    expect = {"w_x": (I, 3 * H), "w_h": (H, 3 * H), "b": (3 * H,),
              "w_fc": (H, K), "b_fc": (K,)}
    for k, shape in expect.items():
        if arr[k].shape != shape:
            raise ValueError(f"KWS weight {k} has shape {arr[k].shape}, "
                             f"expected {shape}")
    return {k: torch.from_numpy(v.copy()).to(device) for k, v in arr.items()}


def load_npz_params(path, device="cpu") -> dict:
    """Weights from a checkpoint's ``arrays.npz`` (``repro/train/
    checkpoint.py``): keys ``w_x``… at the top level or under one prefix
    such as ``params/`` (the trainer's layout)."""
    with np.load(pathlib.Path(path)) as data:
        keys = list(data.keys())
        for prefix in ("", *sorted({k.rsplit("/", 1)[0] + "/"
                                    for k in keys if "/" in k})):
            if all(prefix + k in data for k in PARAM_KEYS):
                return params_from_numpy(
                    {k: data[prefix + k] for k in PARAM_KEYS}, device)
    raise ValueError(f"{path} holds no KWS weights {PARAM_KEYS} "
                     f"(keys: {keys[:8]})")


def serving_weights(params):
    """(DeltaGRUParams, w_fc, b_fc) for a serving session."""
    return (dg.DeltaGRUParams(params["w_x"], params["w_h"], params["b"]),
            params["w_fc"], params["b_fc"])


def forward(params, cfg, feats, threshold: float | None = None,
            backend: str = "xla"):
    """feats: (B, F, C) → (logits (B, K), stats): ΔGRU over the frames,
    mean-pool, FC.  ``backend`` as in ``core.delta_gru.delta_gru_scan``."""
    th = cfg.delta_threshold if threshold is None else threshold
    gru, w_fc, b_fc = serving_weights(params)
    xs = feats.movedim(1, 0)                            # (F, B, C)
    hs, _, stats = dg.delta_gru_scan(gru, xs, threshold=th, backend=backend)
    logits = hs.mean(0) @ w_fc + b_fc
    return logits, stats


def forward_audio(params, cfg, audio, fex, *,
                  threshold: float | None = None, backend: str = "xla"):
    """Raw audio (B, T) → (logits (B, K), stats): FEx → ΔGRU → FC.
    ``fex`` is a ``frontend.fex.FeatureExtractor``."""
    feats, _ = fex.scan(audio, None)
    return forward(params, cfg, feats, threshold, backend)
