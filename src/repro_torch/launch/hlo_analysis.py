"""The collective inventory of a traced sharded step.

Port of ``repro/launch/hlo_analysis.py``.  The reference parses XLA's
post-SPMD HLO text (``compiled.as_text()``), splits it into computations,
multiplies each collective by the trip counts of the while loops around
it and sums their bytes.  Eager PyTorch emits no HLO: the port records
the collectives the step issues while it runs.  :class:`CollectiveRecorder`
is a ``TorchDispatchMode`` that sees every functional collective DTensor
issues on this rank (``_c10d_functional.all_gather_into_tensor``,
``all_reduce``, ``reduce_scatter_tensor``, ``all_to_all_single``, their
coalesced forms, and DTensor's ``shard_dim_alltoall``; DTensor issues
no permute, send or recv); each call becomes
one :class:`CollectiveOp` with its kind, the bytes of its result on this
rank, its group size and the computation it ran in (the innermost
function of the port's models or steps, ``bwd`` in front when it ran in
the backward).  Under a ``fake`` process group and ``FakeTensorMode`` no
collective runs: they are counted, not executed.

Byte accounting, unchanged from the reference (per device, then scaled
by participants):
  all-gather          → output bytes           (each device receives ~out)
  all-reduce          → 2 × bytes              (reduce-scatter + all-gather)
  reduce-scatter      → bytes of the result
  all-to-all          → bytes
``global_bytes`` is ``factor × bytes × participants × multiplier`` and
``collective_summary``'s ``total_bytes`` the global (all-ranks) total, as
the roofline formula ``collective_time = bytes / (chips × link_bw)``
takes it.

Two deliberate differences from the reference, not missing pieces:
  * eager runs every loop iteration, so each call is its own record with
    multiplier 1; ``collective_summary``'s ``count`` is the number of
    calls, not of distinct ops (``grouped`` folds identical records into
    one with its number of calls);
  * ``split_computations`` and ``analyze_collectives(hlo)`` are not
    ported: they parse XLA's text, which nothing in the port produces.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import sys
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}


def shape_bytes(shape, dims=None) -> int:
    """'f32[256,4096,320]' → bytes (tuples: the sum of their elements), as
    the reference counts them; or a torch dtype and its dims."""
    if isinstance(shape, torch.dtype):
        n = 1
        for d in dims:
            n *= int(d)
        return n * shape.itemsize
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", shape):
        dt, ds = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if ds:
            for d in ds.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes_per_device: float
    participants: int
    multiplier: float            # product of enclosing loop trip counts
    computation: str

    @property
    def factor(self) -> float:
        return 2.0 if self.kind == "all-reduce" else 1.0

    @property
    def global_bytes(self) -> float:
        return (self.factor * self.bytes_per_device * self.participants
                * self.multiplier)


def collective_summary(ops: list[CollectiveOp]) -> dict:
    by_kind: dict[str, float] = defaultdict(float)
    for op in ops:
        by_kind[op.kind] += op.global_bytes
    return {
        "total_bytes": sum(o.global_bytes for o in ops),
        "count": len(ops),
        "by_kind": dict(by_kind),
    }


def grouped(ops: list[CollectiveOp]) -> list[dict]:
    """Identical records folded into one, with their number of calls, in
    first-call order."""
    out: dict = {}
    for op in ops:
        key = (op.kind, op.bytes_per_device, op.participants,
               op.multiplier, op.computation)
        if key not in out:
            out[key] = {**dataclasses.asdict(op), "calls": 0}
        out[key]["calls"] += 1
    return list(out.values())


# ------------------------------------------------------- the dispatch modes
# The frames of DTensor's sharding propagation that run an op on
# global-shaped fake tensors only to learn its output's shape.
_SHADOW_FRAMES = frozenset({"_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta"})


def _in_shadow() -> bool:
    f = sys._getframe(2)
    for _ in range(12):
        if f is None:
            return False
        if f.f_code.co_name in _SHADOW_FRAMES:
            return True
        f = f.f_back
    return False


class LocalOpMode(TorchDispatchMode):
    """A mode that sees the ops each rank runs on its local blocks.

    A DTensor op is handed to DTensor (``NotImplemented``), whose local
    ops then come back through the mode stack.  The ops DTensor's sharding
    propagation runs on global-shaped tensors to learn an output's shape
    run below every mode and are not seen, so that the modes under this
    one (``FlopCounterMode``) do not count them either: enter this mode
    last.  Subclasses define ``record(func, args, kwargs, out)``."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if _in_shadow():
            from torch.utils._python_dispatch import _disable_current_modes
            fake = torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE)
            with _disable_current_modes(), (fake or contextlib.nullcontext()):
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self.record(func, args, kwargs, out)
        return out

    def record(self, func, args, kwargs, out):
        pass


# functional collective → the reference's HLO kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")


def _group_size(args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = kwargs.get("group_name", args[-1] if args else None)
    return _resolve_process_group(name).size()


# The port's files that are not a step's computation: placement helpers
# and the dry-run's own instruments.
_NOT_COMPUTATIONS = ("/parallel/", "/launch/hlo_analysis.py",
                     "/launch/dryrun.py")


def computation() -> str:
    """The innermost function of the port's models or launch code on the
    stack (``bwd`` in front inside the backward)."""
    f = sys._getframe(1)
    where = "?"
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        if "/repro_torch/" in fn and not any(n in fn for n in
                                              _NOT_COMPUTATIONS):
            where = f"{fn.rsplit('/repro_torch/', 1)[1]}:{f.f_code.co_name}"
            break
        f = f.f_back
    if torch._C._current_autograd_node() is not None:
        where = f"bwd {where}"
    return where


class CollectiveRecorder(LocalOpMode):
    """Records every functional collective this rank issues as a
    :class:`CollectiveOp` (``ops``), multiplier 1 per call."""

    def __init__(self):
        super().__init__()
        self.ops: list[CollectiveOp] = []

    def record(self, func, args, kwargs, out):
        ns = getattr(func, "namespace", "")
        kind = _KINDS.get(func._overloadpacket.__name__)
        if ns not in _NAMESPACES or kind is None:
            return
        outs = out if isinstance(out, (list, tuple)) else [out]
        nbytes = sum(shape_bytes(t.dtype, t.shape) for t in outs
                     if isinstance(t, torch.Tensor))
        self.ops.append(CollectiveOp(
            kind=kind, bytes_per_device=nbytes,
            participants=_group_size(args, kwargs), multiplier=1.0,
            computation=computation()))
