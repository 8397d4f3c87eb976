"""Multi-pod dry-run: trace every (arch × shape × mesh) cell's sharded step.

Port of ``repro/launch/dryrun.py``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out results/torch_dryrun.json] [--jobs N]

The reference forces 512 host devices, lowers and compiles each cell's
step on the production mesh and reads XLA's analyses.  Here one process
opens a ``fake`` process group of 256 / 512 ranks at rank 0, builds the
step on ``make_production_mesh`` with ``Sharder(mesh=...)`` and runs it
once on fake tensors (``FakeTensorMode``: shapes, dtypes and placements,
no value is ever allocated and no kernel launches; the collectives are
counted, not run).  The step is eager PyTorch, so there is nothing to
compile: ``lower_s`` holds the build's wall seconds (step, specs and fake
inputs) and ``compile_s`` the trace's.

Per cell the record holds every key of the reference's:
  * ``memory``: this rank's bytes.  ``argument_bytes`` is the local
    shards of the inputs, ``output_bytes`` the outputs, ``temp_bytes`` the
    peak live bytes minus the arguments, ``alias_bytes`` the outputs that
    share an input's storage (the in-place cache writes).  The step's
    outputs are live at its end, so they lie inside the peak:
    ``per_device_total_gb`` is the peak, arguments + temp (XLA's temp
    excludes its outputs, hence its arg + temp + out − alias).  Train
    cells raise the microbatches 1 → 2 → 4 → 8 until the peak fits the
    card (``fits_hbm`` under ``hbm_budget_gb``; ``fits_16gb`` keeps the
    reference's key);
  * ``cost_analysis_flops``: ``FlopCounterMode``'s total for rank 0 (its
    local products; XLA's count adds the elementwise ops);
  * ``collectives``: ``hlo_analysis.collective_summary`` of the recorded
    calls (one record per call), with ``collective_calls`` by kind;
  * ``model_flops`` / ``hlo_flops`` / ``hbm_bytes`` / ``tokens``:
    ``costmodel.step_costs``;
  * ``roofline``: the reference's formulas on the H100's figures below;
  * ``device`` and ``torch``: where the fake tensors lived and the torch
    release that traced them (DTensor's choice of collectives, and so
    the records, change between releases).

``--trace-dir`` writes each cell's collectives grouped by computation
(``<cell>.json``) and the holders of its peak (``<cell>.peak.json``:
the computation running when ``LiveBytes`` reached its peak, and the ten
largest storages live then with their shapes, dtypes and the
computations that made them).

Results accumulate in a JSON file (cells already ``ok`` are skipped), so
the campaign is resumable.  ``--device`` is where the fake tensors live:
the card by default, as every entry point of the port, or ``cpu``; the
records do not depend on it except through DTensor's choice of
collective (on a CPU mesh it replaces an all-to-all by an all-gather).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time
import traceback
import weakref

import torch

from repro_torch.launch import hlo_analysis
from repro_torch.launch.hlo_analysis import LocalOpMode
from repro_torch.models import layers as L    # registers the flash ops

# H100 80GB HBM3 (SXM5, 700 W), per card.
PEAK_FLOPS_BF16 = 989e12     # dense bf16 tensor-core FLOP/s: NVIDIA H100 datasheet (SXM5)
HBM_BW = 3.35e12             # B/s of HBM3: the same datasheet
HBM_BYTES = 80e9             # device memory: the same datasheet
# The collective term's bandwidth.  NVLink gives 450 GB/s per direction
# per GPU, but only inside an 8-GPU node; a 16-wide 'model' axis spans two
# nodes, so the term takes the scale-out bandwidth per GPU of an 8-GPU
# node with one 400 Gb/s NIC per GPU (DGX H100, ConnectX-7): 50 GB/s.
NET_BW_PER_GPU = 50e9

MICROBATCHES = (1, 2, 4, 8)


@contextlib.contextmanager
def fake_world(world: int):
    """A ``fake`` process group of ``world`` ranks seen from rank 0 (no
    collective runs), destroyed on exit.  Raises when a process group is
    already initialised: the dry-run never borrows one."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry-run opens its own fake one")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


class LiveBytes(LocalOpMode):
    """The live bytes of this rank's storages: each storage counts once,
    from the op that makes it until it is freed (``peak`` is the most at
    any time).  A collective's wait returns its input, as in eager.

    ``holders=True`` also logs each storage's birth (its bytes, the shape
    and dtype of the tensor that made it, the computation that ran) and
    death, so that ``peak_holders`` can replay the log to the peak: the
    counterpart of the buffer assignment in the reference's HLO dump."""

    def __init__(self, holders: bool = False):
        super().__init__()
        from torch.utils.weak import WeakIdKeyDictionary
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self._log = [] if holders else None
        self._peak_at = (0, None)        # (log length, computation)

    def track(self, st, made_by=None):
        """Count storage ``st`` once, until it is freed (``made_by``: the
        tensor whose op made it, for the log)."""
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        key = id(st)
        weakref.finalize(st, self._free, key, n)
        self.live += n
        where = None
        if self._log is not None:
            where = ("argument" if made_by is None
                     else hlo_analysis.computation())
            self._log.append((key, n, None if made_by is None else (
                tuple(made_by.shape), str(made_by.dtype)), where))
        self._raise_peak(self.live, where)

    def _raise_peak(self, total, where):
        if total > self.peak:
            self.peak = total
            if self._log is not None:
                self._peak_at = (len(self._log), where)

    def _free(self, key, n):
        self.live -= n
        if self._log is not None:
            self._log.append((key, -n, None, None))

    def record(self, func, args, kwargs, out):
        if func is torch.ops._c10d_functional.wait_tensor.default:
            return
        if func in _FLASH_TILES:
            # A flash pass's fake kernel makes only its outputs; its f32
            # tile buffers are live while it runs.
            scratch = _flash_scratch(func, args)
            where = None if self._log is None else (
                f"{hlo_analysis.computation()} (+{scratch} B of flash "
                f"tiles)")
            self._raise_peak(self.live + scratch, where)
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor):
                self.track(t.untyped_storage(), t)

    def peak_holders(self, k: int = 10) -> dict:
        """The computation at which the peak was reached and the ``k``
        largest storages live then: bytes, shape, dtype and the
        computation that made them (``argument``: a step input)."""
        n_log, where = self._peak_at
        live: dict = {}
        for key, n, made, at in self._log[:n_log]:
            if n < 0:
                live.pop(key, None)
            else:
                live[key] = (n, made, at)
        top = sorted(live.values(), key=lambda v: -v[0])[:k]
        return {"peak_bytes": self.peak, "computation": where,
                "live_storages": len(live),
                "largest": [{"bytes": n, "shape": made and list(made[0]),
                             "dtype": made and made[1], "computation": at}
                            for n, made, at in top]}


# (B, K, G, cq, ck) f32 tiles a flash pass holds at once: scores and
# probabilities forward; scores, probabilities, dp and ds backward.
_FLASH_TILES = {torch.ops.repro_torch.flash_fwd.default: 2,
                torch.ops.repro_torch.flash_bwd.default: 4}


def _flash_scratch(func, args) -> int:
    qg, k = args[0], args[1]
    B, S, K, G, Dh = qg.shape
    T = k.shape[1]
    cq, ck = L._pick_chunks(S, T)
    scratch = _FLASH_TILES[func] * B * K * G * cq * ck * 4
    if func is torch.ops.repro_torch.flash_bwd.default:
        scratch += 2 * B * T * K * Dh * 4                # f32 dk, dv
    return scratch


def _locals(tree) -> list:
    """The local tensors of a tree's tensors (a DTensor's block)."""
    from repro_torch.parallel.sharding import tensors_of
    return [t._local_tensor if hasattr(t, "_local_tensor") else t
            for t in tensors_of(tree)]


def _storages(tensors) -> dict:
    """id → (storage, bytes) of each distinct storage."""
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out[id(st)] = (st, st.nbytes())
    return out


def fake_inputs(specs, mesh, device):
    """A fake tensor per spec (a ``meta`` tensor whose ``sharding`` is its
    placement): a DTensor of the spec's global shape whose local block is
    this rank's, or a plain tensor where the spec has no sharding.  Call
    under ``FakeTensorMode``."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.parallel.sharding import map_tensors

    def one(spec):
        sh = getattr(spec, "sharding", None)
        if sh is None:
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        local = list(spec.shape)
        for m, p in enumerate(sh.placements):
            if isinstance(p, Shard):
                local[p.dim] //= mesh.size(m)
        block = torch.zeros(local, dtype=spec.dtype, device=device)
        return DTensor.from_local(
            block, mesh, sh.placements, run_check=False,
            shape=spec.shape,
            stride=torch.empty(spec.shape, device="meta").stride())

    return map_tensors(one, specs)


def _cache_at(cache, index: int):
    """The cache with its write position a Python int (the port's steps
    take one)."""
    if isinstance(cache, dict) and "index" in cache:
        return {**cache, "index": index}
    if hasattr(cache, "_fields") and "index" in cache._fields:
        return cache._replace(index=index)
    return cache


def trace_step(fn, specs, shape, mesh, device, holders=False) -> dict:
    """Run ``fn`` once on fake inputs under ``FlopCounterMode``, the
    collective recorder and the live-bytes tracker (``holders``: with
    the peak's holders, ``"peak"``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.hlo_analysis import CollectiveRecorder
    rec, mem = CollectiveRecorder(), LiveBytes(holders)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = list(fake_inputs(specs, mesh, device))
        if shape.kind != "train":
            # a prefill writes from position 0; a decode step writes
            # the last position of a full cache.
            args[1] = _cache_at(args[1], 0 if shape.kind == "prefill"
                                else shape.seq_len - 1)
        arg_st = _storages(_locals(args))
        for st, _ in arg_st.values():
            mem.track(st)
        arg_bytes = mem.live
        t0 = time.time()
        with FlopCounterMode(display=False) as fc, mem, rec:
            out = fn(*args)
        trace_s = time.time() - t0
        out_st = _storages(_locals(out))
    out_bytes = sum(n for _, n in out_st.values())
    alias = sum(n for k, (_, n) in out_st.items() if k in arg_st)
    return {"ops": rec.ops, "flops": fc.get_total_flops(),
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "alias_bytes": alias, "peak_bytes": mem.peak,
            "trace_s": trace_s,
            "peak": mem.peak_holders() if holders else None}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             trace_dir: str | None = None, *, device: str = "cuda",
             smoke: bool = False) -> dict:
    """One cell's record (``smoke``: the arch's smoke config, for tests)."""
    from repro_torch.configs import LM_SHAPES, get_config, get_smoke_config
    from repro_torch.launch import costmodel
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.parallel.sharding import Sharder
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass "
                           "--device cpu to trace on the CPU")
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = LM_SHAPES[shape_name]
    multi = mesh_kind == "multi"
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device=device)
        chips = mesh.size()
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device == "cuda" else torch.device("cpu"))
        shd = Sharder(mesh=mesh)
        # Adaptive gradient accumulation: escalate microbatches until the
        # cell fits the card's memory (train cells only).
        micro_options = MICROBATCHES if shape.kind == "train" else (1,)
        for micro in micro_options:
            t0 = time.time()
            fn, specs = build_step(cfg, shape, shd, microbatches=micro)
            t_build = time.time() - t0
            tr = trace_step(fn, specs, shape, mesh, dev,
                            holders=trace_dir is not None)
            if tr["peak_bytes"] < HBM_BYTES or micro == micro_options[-1]:
                break
    if trace_dir:
        p = pathlib.Path(trace_dir)
        p.mkdir(parents=True, exist_ok=True)
        cell = f"{arch}__{shape_name}__{mesh_kind}"
        (p / f"{cell}.json").write_text(
            json.dumps(hlo_analysis.grouped(tr["ops"]), indent=1))
        (p / f"{cell}.peak.json").write_text(json.dumps(tr["peak"],
                                                        indent=1))
    csum = hlo_analysis.collective_summary(tr["ops"])
    calls: dict = {}
    for op in tr["ops"]:
        calls[op.kind] = calls.get(op.kind, 0) + 1

    cost = costmodel.step_costs(cfg, shape)
    compute_s = cost.hlo_flops / (chips * PEAK_FLOPS_BF16)
    memory_s = cost.hbm_bytes / (chips * HBM_BW)
    collective_s = csum["total_bytes"] / (chips * NET_BW_PER_GPU)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)

    peak = tr["peak_bytes"]
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": chips,
        "status": "ok", "microbatches": micro, "device": device,
        "torch": torch.__version__,
        "lower_s": round(t_build, 2), "compile_s": round(tr["trace_s"], 2),
        "memory": {
            "argument_bytes": tr["argument_bytes"],
            "output_bytes": tr["output_bytes"],
            "temp_bytes": peak - tr["argument_bytes"],
            "alias_bytes": tr["alias_bytes"],
            "per_device_total_gb": peak / 1e9,
            "hbm_budget_gb": HBM_BYTES / 1e9,
            "fits_hbm": bool(peak < HBM_BYTES),
            "fits_16gb": bool(peak < 16e9),
        },
        "cost_analysis_flops": float(tr["flops"]),
        "collectives": csum,
        "collective_calls": calls,
        "model_flops": cost.model_flops,
        "hlo_flops": cost.hlo_flops,
        "hbm_bytes": cost.hbm_bytes,
        "tokens": cost.tokens,
        "roofline": {**terms, "dominant": dominant,
                     "bound_s": max(terms.values()),
                     "model_vs_hlo_flops": cost.model_flops / max(cost.hlo_flops, 1)},
    }


def _cell_record(arch, shape, mesh, trace_dir, device) -> dict:
    """``run_cell``, or the record of its error."""
    try:
        return run_cell(arch, shape, mesh, trace_dir, device=device)
    except Exception as e:
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def _records(todo, args):
    """(cell, record) of each cell, in one process or in ``--jobs`` worker
    processes (each opens its own fake process group), as they finish."""
    if args.jobs <= 1:
        for cell in todo:
            print(f"[dryrun] {'|'.join(cell)} ...", flush=True)
            yield cell, _cell_record(*cell, args.trace_dir, args.device)
        return
    import concurrent.futures as cf
    import multiprocessing as mp
    with cf.ProcessPoolExecutor(args.jobs,
                                mp_context=mp.get_context("spawn")) as ex:
        futs = {ex.submit(_cell_record, *cell, args.trace_dir, args.device):
                cell for cell in todo}
        for f in cf.as_completed(futs):
            print(f"[dryrun] {'|'.join(futs[f])}", flush=True)
            yield futs[f], f.result()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch_dryrun.json")
    ap.add_argument("--trace-dir", default=None,
                    help="write each cell's recorded collectives here, "
                    "and beside them (<cell>.peak.json) the computation "
                    "at the peak and the ten largest storages live then")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a worker process")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)

    from repro_torch.configs import cells
    todo = []
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        for arch, shape, _ in cells(include_skipped=False):
            for m in meshes:
                todo.append((arch, shape, m))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        for m in meshes:
            todo.append((args.arch, args.shape, m))

    out_path = pathlib.Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())

    pending = []
    for cell in todo:
        key = "|".join(cell)
        if key in results and results[key].get("status") == "ok" \
                and not args.force:
            print(f"[skip cached] {key}", flush=True)
        else:
            pending.append(cell)
    for cell, rec in _records(pending, args):
        results["|".join(cell)] = rec
        out_path.write_text(json.dumps(results, indent=1))
        if rec["status"] == "ok":
            r = rec["roofline"]
            print(f"  ok trace={rec['compile_s']}s "
                  f"micro={rec['microbatches']} "
                  f"mem/dev={rec['memory']['per_device_total_gb']:.2f}GB "
                  f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
                  f"coll={r['collective_s']:.4f}s dominant={r['dominant']}",
                  flush=True)
        else:
            print(f"  ERROR {rec['error']}", flush=True)
    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    print(f"done: {n_ok}/{len(results)} ok")
    return 0 if all(r.get("status") == "ok" for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
