"""Kernel autotuning: sweep the serving kernels' legal launch
configurations on the card, time them, cache the winners.

The counterpart of ``repro/kernels/autotune.py``.  The four serving
kernels take launch knobs whose best values depend on the card and the
shape, not on the numerics:

  * ``delta_gru_seq`` / ``delta_gru_seq_int`` — ``block_b`` (streams per
    launch: the wrapper launches ``B / block_b`` times, over consecutive
    slices of streams, on one CUDA stream) and ``block_t`` (frames of x
    staged in shared memory at a time, clipped to what shared memory
    holds; the float kernel's ``block_t`` 1 is its one-frame-ahead
    register load).
  * ``batched_iir_fex`` / ``batched_iir_fex_int`` — ``block_b`` and
    ``unroll`` (the unroll factor of the warps' per-sample loop over a
    tile: a compile-time instance of the kernel, one library per value,
    ``kernels/build.py::variant``).

``None`` is the default launch: one launch of all B streams, the int
ΔGRU staging ``min(32, T)`` frames, the FEx kernels' own tile loops.
Every knob is NUMERICS-INVARIANT on the card: a launch serves whole
streams, and a staged frame or an unrolled sample runs the identical op
sequence (``chip_smoke.py`` holds every candidate bit for bit against
the default; the plain versions run ``block_b`` slices and stitch the
state back together).  The reference excludes ``block_b=1`` of the float
FEx from its candidates (XLA's codegen for a length-1 batch can round
differently); on the card it is exact, but the candidate list and
``resolve`` keep the exclusion so that both packages answer alike.

The tuner times each candidate the way serving pays for it — on CUDA
with events around the whole wrapper call, its launches included, the
median of ``iters`` after a warm-up; on the CPU with ``perf_counter`` —
and persists the winner in a JSON cache keyed on ``(kernel, shape,
dtype, threshold bucket, platform)``.  The platform is the device:
``cuda-<device name>`` on a GPU, ``cpu-eager`` on the CPU, so one cache
file can hold tunings of several cards, and of both packages (the
reference's platforms are ``<backend>-interpret`` / ``-compiled``).
The scans (``core.delta_gru.delta_gru_scan``, ``core.fixed_point.
int_gru_scan`` / ``int_fex_scan``, ``frontend.fex.fex_scan``) consult the
cache for a knob left ``None``; a ``StreamingKwsSession`` looks its
configurations up once, when it is built, and passes them explicitly, so
its serving step never touches the file.  Lookups NEVER raise: a
missing, corrupt or stale-schema cache reads as "no entry".

Cache environment knobs (the reference's):

  * ``REPRO_AUTOTUNE_CACHE`` — cache file path (default
    ``~/.cache/repro-deltakws/autotune.json``).
  * ``REPRO_AUTOTUNE=0`` — disable cache consultation entirely.

Threshold bucketing: keys carry Δ_TH rounded to the 0.1 grid (clipped to
[0, 1]); a threshold that ``float()`` cannot read falls into bucket 0.0.
The time axis is not part of the key; ``block_t`` applies only where it
divides the chunk being run (``resolve`` / ``sanitize``).
"""
from __future__ import annotations

import json
import logging
import os
import pathlib
import statistics
import time
from typing import Any

SCHEMA_VERSION = 1
ENV_CACHE = "REPRO_AUTOTUNE_CACHE"
ENV_ENABLE = "REPRO_AUTOTUNE"
_DEFAULT_CACHE = "~/.cache/repro-deltakws/autotune.json"

_log = logging.getLogger(__name__)

# In-memory memo of the parsed cache file, invalidated on (path, mtime)
# change so a tune in the same process is visible to later lookups.
_memo: dict[str, Any] = {"stamp": None, "entries": {}}


# ------------------------------------------------------------ legality
def legal_block_b(B: int) -> list[int]:
    """All legal batch-tile sizes: the positive divisors of ``B``."""
    return [d for d in range(1, B + 1) if B % d == 0]


def validate_block_b(kernel: str, B: int, block_b: int | None) -> int:
    """Resolve/validate a batch tile; ``None`` means one tile (``B``).

    Raises ``ValueError`` naming the kernel, ``B`` and the offending
    ``block_b`` (the reference's message, word for word).
    """
    if block_b is None:
        return B
    if (isinstance(block_b, bool) or not isinstance(block_b, int)
            or block_b < 1 or B % block_b != 0):
        raise ValueError(
            f"{kernel}: block_b={block_b!r} is not a positive divisor of "
            f"the batch dimension B={B} (legal values: {legal_block_b(B)})")
    return block_b


def validate_divisor(kernel: str, name: str, value: int | None,
                     axis: str, n: int, default: int = 1) -> int:
    """Shared validation for the other knobs (block_t, unroll)."""
    if value is None:
        return default
    if (isinstance(value, bool) or not isinstance(value, int)
            or value < 1 or n % value != 0):
        raise ValueError(
            f"{kernel}: {name}={value!r} is not a positive divisor of "
            f"{axis}={n}")
    return value


# ------------------------------------------------------------ cache I/O
def cache_path() -> pathlib.Path:
    return pathlib.Path(
        os.environ.get(ENV_CACHE) or _DEFAULT_CACHE).expanduser()


def autotune_enabled() -> bool:
    return os.environ.get(ENV_ENABLE, "1").lower() not in ("0", "false",
                                                           "no")


def clear_memo() -> None:
    """Drop the in-memory cache memo (tests / after env changes)."""
    _memo["stamp"] = None
    _memo["entries"] = {}


def _load_entries() -> dict:
    """Parsed cache entries; {} on ANY problem (missing/corrupt/stale).

    Never raises — a broken cache file must degrade to the defaults, not
    take the serving path down.
    """
    path = cache_path()
    try:
        stamp = (str(path), path.stat().st_mtime_ns)
    except OSError:
        return {}
    if _memo["stamp"] == stamp:
        return _memo["entries"]
    try:
        blob = json.loads(path.read_text())
        if not isinstance(blob, dict) or blob.get("schema") != SCHEMA_VERSION:
            raise ValueError(f"schema {blob.get('schema')!r} != "
                             f"{SCHEMA_VERSION}")
        entries = blob["entries"]
        if not isinstance(entries, dict):
            raise ValueError("entries is not a mapping")
    except Exception as e:                       # corrupt / stale / unreadable
        _log.warning("autotune cache %s unusable (%s); using defaults",
                     path, e)
        entries = {}
    _memo["stamp"] = stamp
    _memo["entries"] = entries
    return entries


def threshold_bucket(threshold) -> float:
    """Δ_TH → the 0.1-grid bucket used in cache keys (see module doc)."""
    try:
        th = float(threshold)
    except Exception:                # not a number — see module doc
        return 0.0
    return min(max(round(th * 10.0) / 10.0, 0.0), 1.0)


def platform_tag(device=None) -> str:
    """The cache's platform for ``device``: ``cuda-<device name>`` or
    ``cpu-eager``.  ``None`` is the port's default device: CUDA where
    there is one, else the CPU (a key, not a placement)."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda-{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}-eager"


def cache_key(kernel: str, shape: tuple[int, ...], dtype: str,
              threshold, device=None) -> str:
    return "|".join([kernel, "x".join(str(int(d)) for d in shape),
                     str(dtype), f"th{threshold_bucket(threshold):g}",
                     platform_tag(device)])


def lookup(kernel: str, shape: tuple[int, ...], dtype: str, threshold,
           device=None) -> dict | None:
    """Raw cache hit for a key, or None.  Never raises."""
    try:
        key = cache_key(kernel, shape, dtype, threshold, device)
    except Exception as e:           # an unreadable device — no entry
        _log.warning("autotune lookup: no platform tag (%s)", e)
        return None
    entry = _load_entries().get(key)
    if not isinstance(entry, dict):
        return None
    cfg = entry.get("config")
    return dict(cfg) if isinstance(cfg, dict) else None


def record(kernel: str, shape: tuple[int, ...], dtype: str, threshold,
           config: dict, *, tuned_us: float, default_us: float,
           device=None) -> str:
    """Persist a tuned winner (atomic write: tmp file + rename).  A knob
    left ``None`` (the default launch) is not written."""
    path = cache_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        blob = json.loads(path.read_text())
        if blob.get("schema") != SCHEMA_VERSION:
            raise ValueError("stale schema")
        entries = dict(blob["entries"])
    except (OSError, ValueError, TypeError, KeyError, AttributeError):
        entries = {}              # missing, corrupt or stale: start afresh
    key = cache_key(kernel, shape, dtype, threshold, device)
    entries[key] = {
        "config": {k: int(v) for k, v in config.items() if v is not None},
        "tuned_us": float(tuned_us), "default_us": float(default_us),
        "speedup": float(default_us / tuned_us) if tuned_us else None,
        "recorded_unix": time.time(),
    }
    # Writer-unique tmp name: concurrent tuners (separate processes
    # sharing one cache file) must never interleave writes into the
    # same tmp file — each stages its own complete blob and the atomic
    # rename makes last-writer-wins the worst case, never corruption.
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        tmp.write_text(json.dumps({"schema": SCHEMA_VERSION,
                                   "entries": entries}, indent=2) + "\n")
        tmp.replace(path)
    finally:
        tmp.unlink(missing_ok=True)
    clear_memo()
    return key


def sanitize(kernel: str, cfg: dict | None, *, B: int | None = None,
             T: int | None = None, frame_shift: int | None = None) -> dict:
    """A raw cached config with every knob that is illegal for this call
    dropped: a ``block_b`` that does not divide ``B``, a ``block_t`` that
    does not divide this chunk's ``T``, an ``unroll`` that does not divide
    ``frame_shift``, and the float FEx's ``block_b=1``.  Pure: reads no
    file (the session calls it every step)."""
    if not cfg:
        return {}
    out = {}
    bb = cfg.get("block_b")
    if isinstance(bb, int) and B and bb >= 1 and B % bb == 0:
        if not (kernel == "batched_iir_fex" and bb == 1):
            out["block_b"] = bb
    bt = cfg.get("block_t")
    if isinstance(bt, int) and T and bt >= 1 and T % bt == 0:
        out["block_t"] = bt
    un = cfg.get("unroll")
    if (isinstance(un, int) and frame_shift and un >= 1
            and frame_shift % un == 0):
        out["unroll"] = un
    return out


def resolve(kernel: str, shape: tuple[int, ...], dtype: str, threshold, *,
            device=None, B: int | None = None, T: int | None = None,
            frame_shift: int | None = None) -> dict:
    """Dispatch-side consult: the tuned config SANITIZED for this call
    (``sanitize``), so a cache tuned at one chunk geometry can never
    produce an error — at worst a knob falls back to its default.
    Returns {} when autotuning is disabled or there is no entry.  Never
    raises."""
    if not autotune_enabled():
        return {}
    return sanitize(kernel, lookup(kernel, shape, dtype, threshold, device),
                    B=B, T=T, frame_shift=frame_shift)


# --------------------------------------------------------------- timing
def _time_us(fn, device, iters: int = 3, warmup: int = 1) -> float:
    """Median µs of ``fn()`` over ``iters`` calls after ``warmup``: CUDA
    events around each whole call on a GPU, the host clock on the CPU."""
    import torch
    dev = torch.device(device)
    for _ in range(warmup):
        fn()
    ts = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(iters):
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
    return float(statistics.median(ts))


def _block_b_candidates(B: int, *, exclude_one: bool = False) -> list[int]:
    cands = [d for d in legal_block_b(B)
             if d == B or d in (1, 2, 4, 8, 16, 32, 64, 128)]
    if exclude_one and len(cands) > 1:
        cands = [d for d in cands if d != 1]
    return cands


def _tile_candidates(n: int, cap: int = 32) -> list[int]:
    """All divisors of ``n`` up to ``cap`` (∪ {n} when n <= cap)."""
    cands = [d for d in range(1, min(n, cap) + 1) if n % d == 0]
    if n <= cap and n not in cands:
        cands.append(n)
    return cands


def _greedy_sweep(time_config, default_cfg: dict,
                  axes: list[tuple[str, list[int]]]) -> dict:
    """Tune one axis at a time, holding winners fixed — |axes| · |cands|
    timings instead of the full cross product.  Returns the report."""
    sweep = []
    best_cfg = dict(default_cfg)
    default_us = time_config(default_cfg)
    sweep.append(dict(default_cfg, us=default_us, role="default"))
    best_us = default_us
    for name, cands in axes:
        for v in cands:
            cfg = dict(best_cfg, **{name: v})
            if cfg == best_cfg or cfg == default_cfg:
                continue
            us = time_config(cfg)
            sweep.append(dict(cfg, us=us, role="candidate"))
            if us < best_us:
                best_us, best_cfg = us, cfg
    return {"default_config": default_cfg, "default_us": default_us,
            "best_config": best_cfg, "best_us": best_us,
            "speedup": default_us / best_us if best_us else None,
            "sweep": sweep}


# --------------------------------------------------------------- tuners
def tune_delta_gru_seq(*, T: int = 100, B: int = 8, I: int = 64,
                       H: int = 64, threshold: float = 0.2,
                       variant: str = "float", iters: int = 3,
                       write: bool = True, seed: int = 0,
                       device=None) -> dict:
    """Sweep (block_t, block_b) for the ΔGRU sequence kernel on
    ``device`` (default CUDA; raises without a GPU).

    ``variant="float"`` times ``delta_gru_seq``; ``"int"`` times the
    promoted int8 path through ``fixed_point.int_gru_scan``.  The default
    configuration is today's launch (float ``block_t`` 1; int ``block_t``
    None, ``min(32, T)`` staged frames).  Records the winner under the
    dispatch's cache key and returns the full before/after report.
    """
    import numpy as np
    import torch

    from repro_torch.core import delta_gru as dg
    from repro_torch.kernels.platform import resolve_device

    dev = resolve_device(device)
    p_cpu = dg.init_delta_gru(torch.Generator().manual_seed(seed), I, H)
    p = dg.DeltaGRUParams(*(t.to(dev) for t in p_cpu))
    xs = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (T, B, I)).astype(np.float32) * 0.5).to(dev)
    s0 = dg.init_delta_state(B, I, H, p)

    if variant == "float":
        from repro_torch.kernels.delta_gru_seq import delta_gru_seq
        kernel, dtype = "delta_gru_seq", "float32"
        default = {"block_b": B, "block_t": 1}

        def time_config(cfg):
            return _time_us(lambda: delta_gru_seq(
                xs, *s0, p.w_x, p.w_h, threshold, **cfg), dev, iters=iters)
    elif variant == "int":
        from repro_torch.core import fixed_point as fp
        kernel, dtype = "delta_gru_seq_int", "int8"
        default = {"block_b": B, "block_t": None}
        w, fmt = fp.quantize_gru(p_cpu)
        w = fp.IntGruWeights(*(t.to(dev) for t in w))
        xs_codes = fp.to_code(xs, fmt.feat_frac, 16, torch.int16)
        si = fp.init_int_delta_state(B, I, H, w)

        def time_config(cfg):
            return _time_us(lambda: fp.int_gru_scan(
                w, fmt, xs_codes, threshold, state=si, backend="pallas",
                consult_cache=False, **cfg), dev, iters=iters)
    else:
        raise ValueError(f"unknown ΔGRU tune variant: {variant!r}")

    report = _greedy_sweep(
        time_config, default,
        [("block_t", _tile_candidates(T)), ("block_b", _block_b_candidates(B))])
    report.update(kernel=kernel, shape=[B, I, H], dtype=dtype, T=T,
                  threshold=threshold, platform=platform_tag(dev))
    if write:
        report["cache_key"] = record(
            kernel, (B, I, H), dtype, threshold, report["best_config"],
            tuned_us=report["best_us"], default_us=report["default_us"],
            device=dev)
    return report


def tune_batched_iir_fex(*, B: int = 8, seconds: float = 0.5,
                         variant: str = "float", iters: int = 3,
                         write: bool = True, seed: int = 0, fex_cfg=None,
                         device=None) -> dict:
    """Sweep (unroll, block_b) for the FEx kernel on ``device`` (default
    CUDA; raises without a GPU).

    Uses the repo's deployed filterbank geometry (``FExConfig`` defaults:
    10 active channels, 128-sample frames) unless ``fex_cfg`` overrides.
    The default configuration is today's launch (``unroll`` None).  A
    candidate ``unroll`` builds its kernel instance on first use.
    """
    import numpy as np
    import torch

    from repro_torch.frontend.fex import FExConfig, build_sos_bank
    from repro_torch.kernels.iir_fex import (init_fex_kernel_state,
                                             pack_coefficients)
    from repro_torch.kernels.platform import resolve_device

    dev = resolve_device(device)
    cfg = fex_cfg or FExConfig()
    bank = build_sos_bank(cfg)
    coef = pack_coefficients(bank)
    C, fs = coef.shape[1], int(cfg.fs)
    n = int(fs * seconds)
    audio = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, n)).astype(np.float32) * 0.1).to(dev)
    frame_shift = cfg.frame_shift

    if variant == "float":
        from repro_torch.kernels.iir_fex import batched_iir_fex
        kernel, dtype = "batched_iir_fex", "float32"
        coef = coef.to(dev)
        state = init_fex_kernel_state(B, C, dev)

        def time_config(c):
            return _time_us(lambda: batched_iir_fex(
                audio, coef, state, frame_shift=frame_shift,
                env_alpha=cfg.env_alpha, log_eps=cfg.log_eps, **c), dev,
                iters=iters)
    elif variant == "int":
        from repro_torch.core import fixed_point as fp
        from repro_torch.frontend.fex import sos_formats
        from repro_torch.kernels.iir_fex import batched_iir_fex_int
        kernel, dtype = "batched_iir_fex_int", "int16"
        b_fmt, a_fmt = sos_formats(bank, cfg.b_bits, cfg.a_bits)
        codes, ffmt = fp.quantize_fex(coef.double().numpy(), cfg.env_alpha,
                                      b_fmt.frac_bits, a_fmt.frac_bits,
                                      log_eps=cfg.log_eps)
        codes = codes.to(dev)
        audio_codes = fp.to_code(audio, ffmt.feat_frac, 16, torch.int16)
        state = fp.init_int_fex_state(B, C, dev)

        def time_config(c):
            return _time_us(lambda: batched_iir_fex_int(
                audio_codes, codes, state, fmt=ffmt,
                frame_shift=frame_shift, **c), dev, iters=iters)
    else:
        raise ValueError(f"unknown FEx tune variant: {variant!r}")

    report = _greedy_sweep(
        time_config, {"block_b": B, "unroll": None},
        [("unroll", _tile_candidates(frame_shift, cap=16)),
         ("block_b", _block_b_candidates(B, exclude_one=variant == "float"))])
    report.update(kernel=kernel, shape=[B, C, frame_shift], dtype=dtype,
                  seconds=seconds, threshold=0.0, platform=platform_tag(dev))
    if write:
        report["cache_key"] = record(
            kernel, (B, C, frame_shift), dtype, 0.0, report["best_config"],
            tuned_us=report["best_us"], default_us=report["default_us"],
            device=dev)
    return report


# ----------------------------------------------------------------- CLI
def build_parser():
    import argparse
    ap = argparse.ArgumentParser(
        prog="repro_torch.kernels.autotune",
        description="Tune the four serving kernels on the card at a "
                    "session's shapes and record the winners in the "
                    "autotune cache ($REPRO_AUTOTUNE_CACHE, default "
                    "~/.cache/repro-deltakws/autotune.json), where every "
                    "session built afterwards on the same card finds them.")
    ap.add_argument("--slots", type=int, default=256,
                    help="streams served together (the batch B)")
    ap.add_argument("--chunk-samples", type=int, default=4096,
                    help="samples per serve step (frames = chunk / 128)")
    ap.add_argument("--threshold", type=float, default=0.1,
                    help="the ΔGRU's Δ_TH (its cache bucket)")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls per candidate (median)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    return ap


def main(argv=None) -> int:
    """Tune the float and int8 FEx and ΔGRU kernels at one serving shape,
    printing each kernel's default and best µs and its winner."""
    from repro_torch.frontend.fex import FExConfig
    args = build_parser().parse_args(argv)
    fcfg = FExConfig()
    frames = args.chunk_samples // fcfg.frame_shift
    for variant in ("float", "int"):
        for rep in (
                tune_batched_iir_fex(B=args.slots,
                                     seconds=args.chunk_samples / fcfg.fs,
                                     variant=variant, iters=args.iters,
                                     device=args.device),
                tune_delta_gru_seq(T=frames, B=args.slots,
                                   I=fcfg.n_active, H=64,
                                   threshold=args.threshold,
                                   variant=variant, iters=args.iters,
                                   device=args.device)):
            print(f"{rep['kernel']} {rep['shape']}: default "
                  f"{rep['default_us']:.1f} µs {rep['default_config']}, "
                  f"best {rep['best_us']:.1f} µs {rep['best_config']} "
                  f"({len(rep['sweep'])} configurations, {rep['platform']})")
    print(f"recorded in {cache_path()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
