"""The paper's model: IIR FEx → ΔGRU(64) → FC(12) keyword spotter.

Port of ``repro/models/kws.py``: the forwards (utterance and per-frame),
the training losses (mean-pool cross-entropy, per-frame and max-pool
detection losses), QAT (8-bit straight-through weights, the hidden state
snapped to Q0.15) and the 11-class metric, plus the weight converters
``params_from_numpy`` / ``params_to_numpy``: a parameter tree is a plain
dict of float32 tensors ``{"w_x", "w_h", "b", "w_fc", "b_fc"}`` with the
JAX package's names, shapes and layouts, so the same numpy arrays serve
and train in both packages.

Training differentiates the eager ``backend="xla"`` ΔGRU loop with
``torch.autograd``; the losses are functions of the parameter dict, as
the reference's are of its pytree.
"""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from repro_torch.core import delta_gru as dg
from repro_torch.core.quantize import QFormat, WEIGHT_Q, ste_quantize
from repro_torch.kernels.xla_math import xla_log2

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


def params_to_numpy(params) -> dict:
    """The reverse of ``params_from_numpy``: float32 numpy arrays under the
    JAX package's names (``repro.models.kws`` takes them as they are)."""
    return {k: params[k].detach().cpu().numpy().astype(np.float32)
            for k in PARAM_KEYS}


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


def _weight_scale(w: torch.Tensor) -> torch.Tensor:
    """The STE weights' per-tensor scale, ``2^ceil(log2(max|w|))`` with
    max|w| floored at 1e-8, as the reference computes it under jit: log2
    is XLA's (``xla_log2``; a libm log2 can land on the other side of an
    integer at a power of two and halve or double the scale), and 2^e is
    built in the exponent bits, exactly, on ``w``'s device."""
    m = torch.clamp_min(w.detach().abs().amax(), float(np.float32(1e-8)))
    e = torch.ceil(xla_log2(m))
    bits = (e.clamp(-126.0, 127.0).to(torch.int32) + 127) << 23
    return torch.where(torch.isfinite(e), bits.view(torch.float32), e)


def _gru_params(params, quantize_8b: bool) -> dg.DeltaGRUParams:
    w_x, w_h = params["w_x"], params["w_h"]
    if quantize_8b:
        # Per-tensor power-of-two scale, 8-bit STE (IC weight format).
        def q(w):
            scale = _weight_scale(w)
            return ste_quantize(w / scale, WEIGHT_Q) * scale
        w_x, w_h = q(w_x), q(w_h)
    return dg.DeltaGRUParams(w_x, w_h, params["b"])


def serving_weights(params, quantize_8b: bool = False, mesh=None):
    """(DeltaGRUParams, w_fc, b_fc) for a serving session (``quantize_8b``:
    the STE weights' values, the float image of the int8 codes),
    replicated over ``mesh``: a list with one copy per shard, on its
    device (the tuple itself when ``mesh`` is None).

    Replication is the serving sharding contract: every shard reads its
    weights from its own device's memory and admission never moves them;
    only per-stream state is partitioned (``parallel/sharding.py``)."""
    from repro_torch.parallel import sharding as shp
    weights = (_gru_params(params, quantize_8b), params["w_fc"],
               params["b_fc"])
    return shp.put_replicated(weights, mesh)


# The integer serving path stores ĥ on the Q0.15 grid; QAT snaps the
# training-time hidden state to the same grid (straight-through).
QAT_H_FORMAT = QFormat(int_bits=0, frac_bits=15)


def _gru_hidden(params, cfg, feats, threshold, quantize_8b, backend, qat):
    """Shared forward scaffolding: feats (B, F, C) → (hs (F, B, H),
    stats): threshold/backend resolution and the QAT wiring, so
    ``forward`` and ``forward_frames`` agree up to the pooling."""
    th = cfg.delta_threshold if threshold is None else threshold
    be = getattr(cfg, "gru_backend", "xla") if backend is None else backend
    gru = _gru_params(params, quantize_8b or qat)
    xs = feats.movedim(1, 0)                            # (F, B, C)
    hs, _, stats = dg.delta_gru_scan(
        gru, xs, threshold=th, backend=be,
        h_qformat=QAT_H_FORMAT if qat else None)
    return hs, stats


def forward(params, cfg, feats, threshold: float | None = None,
            quantize_8b: bool = False, backend: str | None = None,
            qat: bool = False):
    """feats: (B, F, C) → (logits (B, K), stats): ΔGRU over the frames,
    mean-pool, FC.

    ``backend`` as in ``core.delta_gru.delta_gru_scan``: "xla" (the
    default; the differentiable eager loop, the training path) or
    "pallas" (the ``delta_gru_seq`` kernel on a CUDA tensor, its plain
    version on a CPU tensor; no gradient).  ``qat=True`` simulates the
    deployed integer numerics in training: 8-bit STE weights (implies
    ``quantize_8b``) and the hidden state on the Q0.15 grid with a
    straight-through gradient ("xla" only).
    """
    hs, stats = _gru_hidden(params, cfg, feats, threshold, quantize_8b,
                            backend, qat)
    logits = hs.mean(0) @ params["w_fc"] + params["b_fc"]
    return logits, stats


def forward_audio(params, cfg, audio, fex, *,
                  threshold: float | None = None, quantize_8b: bool = False,
                  backend: str | None = None):
    """Raw audio (B, T) → (logits (B, K), stats): FEx → ΔGRU → FC.
    ``fex`` is a ``frontend.fex.FeatureExtractor``."""
    feats, _ = fex.scan(audio, None)
    return forward(params, cfg, feats, threshold, quantize_8b, backend)


def forward_frames(params, cfg, feats, threshold: float | None = None,
                   quantize_8b: bool = False, backend: str | None = None,
                   qat: bool = False):
    """feats: (B, F, C) → (per-frame logits (F, B, K), stats): the
    detection-mode forward, no pooling — every 16 ms frame gets the logit
    vector the serving step's FC head computes per decision."""
    hs, stats = _gru_hidden(params, cfg, feats, threshold, quantize_8b,
                            backend, qat)
    return hs @ params["w_fc"] + params["b_fc"], stats


def _edge_weights(labels, smear_frames: int):
    """(F, B) float32 label-smearing weights: 1 everywhere except within
    ``smear_frames`` frames of a label transition, where the weight is 0
    (event edges at frame granularity are arbitrary, so they are not
    scored)."""
    if smear_frames <= 0:
        return torch.ones(labels.shape, device=labels.device)
    edge = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
    edge[1:] = labels[1:] != labels[:-1]                 # transition frames
    smeared = edge.clone()
    for k in range(1, smear_frames + 1):
        smeared[:-k] |= edge[k:]
        smeared[k:] |= edge[:-k]
    return (~smeared).float()


def _accuracy(logits, labels):
    return (logits.argmax(-1) == labels).float().mean()


def frame_loss_fn(params, cfg, batch: dict, threshold: float | None = None,
                  quantize_8b: bool = False, qat: bool = False, *,
                  loss_mode: str = "frame_ce", smear_frames: int = 0):
    """Detection-training loss over per-frame logits.

    batch: {"feats": (B, F, C), "frame_labels": (B, F) int} (labels from
    ``data.continuous.synth_frame_batch``).  loss_mode "frame_ce": the
    cross-entropy of every frame; "maxpool": background (label 0) frames
    keep their per-frame CE, and each keyword occurrence is scored only at
    its frame with the largest target logit (per (row, class)).
    ``smear_frames`` zeroes the weight of frames that close to a label
    transition.  Returns ``(ce, {"ce", "acc", "sparsity"})``.
    """
    if loss_mode not in ("frame_ce", "maxpool"):
        raise ValueError(f"unknown loss_mode {loss_mode!r} "
                         f"(choose frame_ce / maxpool)")
    logits, stats = forward_frames(params, cfg, batch["feats"], threshold,
                                   quantize_8b, qat=qat)
    labels = batch["frame_labels"].long().movedim(1, 0)  # (F, B)
    logp = torch.log_softmax(logits, -1)                 # (F, B, K)
    w = _edge_weights(labels, smear_frames)              # (F, B)
    frame_ce = -logp.gather(-1, labels[..., None])[..., 0]   # (F, B)
    if loss_mode == "frame_ce":
        ce = (w * frame_ce).sum() / w.sum().clamp_min(1.0)
    else:
        n_classes = logits.shape[-1]
        bg = w * (labels == 0)
        bg_ce = (bg * frame_ce).sum() / bg.sum().clamp_min(1.0)
        klass = torch.arange(n_classes, device=labels.device)
        owns = labels[..., None] == klass                # (F, B, K)
        cls_score = torch.where(owns, logits.detach(),
                                torch.full_like(logits, -float("inf")))
        fstar = cls_score.argmax(0)                      # (B, K)
        b_ix = torch.arange(labels.shape[1], device=labels.device)[:, None]
        pooled_logp = torch.log_softmax(logits[fstar, b_ix, :], -1)
        pooled_ce = -pooled_logp.diagonal(dim1=1, dim2=2)    # (B, K)
        present = owns.any(0) & (klass > 0)              # keywords only
        ev_ce = torch.where(present, pooled_ce, 0.0).sum() / \
            present.sum().clamp_min(1)
        ce = bg_ce + ev_ce
    acc = _accuracy(logits, labels)
    return ce, {"ce": ce, "acc": acc,
                "sparsity": dg.temporal_sparsity(stats)}


def loss_fn(params, cfg, batch: dict, threshold: float | None = None,
            quantize_8b: bool = False, qat: bool = False):
    """Utterance-level training loss: mean-pool logits against
    ``batch["labels"]`` (B,).  Returns ``(ce, {"ce", "acc", "sparsity"})``."""
    logits, stats = forward(params, cfg, batch["feats"], threshold,
                            quantize_8b, qat=qat)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, -1)
    ce = -logp.gather(-1, labels[:, None]).mean()
    return ce, {"ce": ce, "acc": _accuracy(logits, labels),
                "sparsity": dg.temporal_sparsity(stats)}


def accuracy_11class(logits, labels):
    """11-class GSCD metric: 'unknown' (class 1) excluded."""
    keep = labels != 1
    logits11 = logits.clone()
    logits11[:, 1] = -float("inf")
    correct = torch.where(keep, logits11.argmax(-1) == labels, False)
    return correct.sum() / keep.sum().clamp_min(1)
