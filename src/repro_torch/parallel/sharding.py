"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.

Port of ``repro/parallel/sharding.py``.  Every tensor carries *logical*
dimension names ("batch", "embed", "mlp", "heads", ...).  A
:class:`Sharder` resolves them to a ``PartitionSpec`` for a mesh:

  * each logical name has an ordered list of candidate mesh-axis tuples;
  * a candidate is accepted only if all its axes exist in the mesh, none is
    already used by an earlier dimension of the same tensor, and the dim is
    evenly divisible by the product of the axis sizes;
  * otherwise the next candidate is tried, ending at ``None`` (replicated).

``Sharder.spec`` is pure arithmetic over axis sizes: it takes a
``torch.distributed.DeviceMesh`` (``mesh_dim_names`` / ``mesh.shape``) or
any object with ``axis_names`` and ``devices.shape``.  With ``mesh=None``
(one device) ``act``, ``sharding``, ``shard_params`` and
``param_shardings`` are identities, as in the reference.

On a ``DeviceMesh`` (one process per rank) the reference's GSPMD
placement is DTensor's: a spec becomes one placement per mesh dim,
``Shard(d)`` where the mesh axis names tensor dim ``d`` and
``Replicate()`` elsewhere.  A joint entry such as ``("pod", "data")``
shards dim ``d`` on both mesh dims in mesh-dim order, so rank
``(pod=i, data=j)`` holds block ``i·n_data + j``: the reference's
major-to-minor order.  ``act`` is a differentiable ``redistribute`` (the
counterpart of ``with_sharding_constraint``), ``shard_params`` cuts every
leaf out of the same whole tensor on every rank (no communication), and
``sharding`` / ``param_shardings`` give :class:`NamedSharding`s.  Model
code runs under ``Sharder.scope()``: plain tensors made inside it (a
position ``arange``, a causal mask) are read as replicated.

The slot axis of the sharded KWS engine (DESIGN.md §6) is ported: on a
``launch.mesh.SlotMesh`` a sharded value is a list with one entry per
shard.  ``put_slot_sharded`` gives shard ``i`` the contiguous block of
rows ``[i·B/n, (i+1)·B/n)`` of every leaf on its device; ``put_replicated``
gives every shard the copy of its device (shards on one device share it).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Sequence

import numpy as np
import torch


class PartitionSpec(tuple):
    """A tuple of per-dimension mesh axes (an axis name, a tuple of axis
    names, or None = replicated), compared as a tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):            # pickles as P(*parts)
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# Ordered candidates per logical axis name.  Tuples = joint sharding over
# several mesh axes.  None = replicate.
DEFAULT_RULES: dict[str, list[Any]] = {
    # --- parameters -------------------------------------------------------
    "vocab": [("model",)],
    "embed": [("pod", "data"), ("data",)],          # FSDP weight sharding
    "mlp": [("model",)],                             # tensor parallel
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "qkv": [("model",)],                             # fused qkv output dim
    "expert": [("pod",), ("model",)],                # EP across pods
    "layers": [],
    "conv": [], "state": [], "head_dim": [], "dt": [],
    # --- activations ------------------------------------------------------
    "batch": [("pod", "data"), ("data",)],
    "seq": [],                                       # unsharded in train
    "res_seq": [("model",)],                         # sequence parallelism
    "kv_seq": [("data",), ("model",)],               # context parallelism
    "act_embed": [],
    "act_mlp": [("model",)],
    "act_heads": [("model",)],
    "act_vocab": [("model",)],
    "frames": [], "channels": [],
    # --- serving -----------------------------------------------------------
    "slots": [("data",)],        # streaming-KWS slot axis
    None: [],
}

SLOT_AXIS = "data"


def slot_shards(mesh) -> int:
    """Number of slot partitions a mesh provides (1 without a mesh)."""
    if mesh is None:
        return 1
    if SLOT_AXIS not in mesh.axis_names:
        raise ValueError(f"serving mesh needs a {SLOT_AXIS!r} axis, "
                         f"got {mesh.axis_names}")
    return int(dict(zip(mesh.axis_names, mesh.devices.shape))[SLOT_AXIS])


def check_slot_partition(mesh, n_slots: int) -> int:
    """Validate ``n_slots`` divides over the mesh; returns shard count.

    Divisibility is a hard requirement (not a fallback-to-replicated like
    the training rules): a ragged slot axis would give shards different
    batch shapes.
    """
    shards = slot_shards(mesh)
    if n_slots % shards != 0:
        raise ValueError(f"{n_slots} slots do not partition over "
                         f"{shards} devices; pick a multiple")
    return shards


def _map_leaves(fn, tree):
    """``fn`` over the leaves of a tree of dicts, NamedTuples, tuples and
    lists; None stays None (an empty subtree, as in a JAX pytree)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[_map_leaves(fn, v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def slot_specs(tree) -> Any:
    """Prefix PartitionSpec tree: axis 0 = slots, sharded over the mesh
    (trailing dims unsharded, so one spec covers leaves of any rank)."""
    return _map_leaves(lambda _: P(SLOT_AXIS), tree)


def replicated_specs(tree) -> Any:
    """PartitionSpec tree replicating every leaf (weights, coefficients)."""
    return _map_leaves(lambda _: P(), tree)


def map_tensors(fn, tree):
    """``fn`` over the tensors of a tree of dicts, NamedTuples, tuples and
    lists (every other leaf is kept as it is)."""
    return _map_leaves(
        lambda x: fn(x) if isinstance(x, torch.Tensor) else x, tree)


def tensors_of(tree) -> list:
    """The tensors of a tree, as ``map_tensors`` visits them."""
    out: list = []
    map_tensors(out.append, tree)
    return out


def replicate(make, mesh) -> list:
    """``make(device)`` once per distinct device of ``mesh``, as a list with
    one entry per shard (shards on one device share that device's copy).
    On a card every shard's stream waits for the copies, and their memory
    is held until the work queued on the shard's stream is done."""
    copies: dict = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = make(d)
    out = [copies[d] for d in mesh.devices]
    if mesh.is_cuda:
        for i, tree in enumerate(out):
            s = mesh.stream(i)
            s.wait_stream(torch.cuda.current_stream(mesh.device(i)))
            for leaf in tensors_of(tree):
                leaf.record_stream(s)
    return out


def put_replicated(tree, mesh):
    """Weights replicated over the mesh: one copy of ``tree`` per shard,
    on its device (``tree`` itself without a mesh)."""
    if mesh is None:
        return tree
    return replicate(lambda d: map_tensors(lambda x: x.to(d), tree), mesh)


def put_slot_sharded(tree, mesh):
    """Per-stream state with axis 0 partitioned over the mesh: shard ``i``
    gets a copy of rows ``[i·B/n, (i+1)·B/n)`` of every leaf, on its device
    and stream (``tree`` itself without a mesh)."""
    if mesh is None:
        return tree
    n = mesh.size

    def block(x, i):
        b = x.shape[0] // check_slot_partition(mesh, x.shape[0])
        if x.is_cuda and mesh.is_cuda:
            mesh.stream(i).wait_stream(torch.cuda.current_stream(x.device))
        with mesh.shard(i):
            y = x[i * b:(i + 1) * b].to(mesh.device(i), copy=True)
        if x.is_cuda and mesh.is_cuda:
            x.record_stream(mesh.stream(i))
        return y

    return [map_tensors(lambda x: block(x, i), tree) for i in range(n)]


# Decode overrides: serving keeps tensor parallelism on 'model' and
# replicates weights over the data axes (no per-layer weight all-gather).
DECODE_RULES: dict[str, list[Any]] = {
    "embed": [("model",)],
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's placement on a ``DeviceMesh``: the mesh, the
    PartitionSpec it came from and the DTensor placements, one per mesh
    dim (the counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec
    placements: tuple


def _mesh_axes(mesh) -> tuple[tuple, tuple]:
    """(axis names, axis sizes) of a ``DeviceMesh`` or of an object with
    ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), tuple(int(n) for n in mesh.shape)
    return tuple(mesh.axis_names), tuple(mesh.devices.shape)


def spec_placements(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` if that axis names tensor dim ``d`` (alone or in a joint
    entry), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in _mesh_axes(mesh)[0]:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def place(x, sharding: NamedSharding | None):
    """``x`` with ``sharding``'s placements: a DTensor is redistributed
    (through its whole value when it lies on another mesh); a plain tensor,
    the same whole value on every rank, is cut locally on the mesh's
    device (no communication).  ``None`` leaves ``x`` as it is."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if sharding is None:
        return x
    mesh = sharding.mesh
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, sharding.placements)
        x = x.full_tensor()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    return distribute_tensor(x.detach().to(dev), mesh, sharding.placements,
                             src_data_rank=None)


def local_bounds(x, dim: int) -> tuple[int, int]:
    """[lo, hi) of this rank's block of DTensor ``x`` along ``dim`` (the
    whole dim for a plain tensor); blocks are even, as ``Sharder.spec``
    shards only dims its axes divide."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(x):
        return 0, x.shape[dim]
    mesh, size, lo = x.device_mesh, x.shape[dim], 0
    coord = mesh.get_coordinate()
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.size(m)
            lo += coord[m] * size
    return lo, lo + size


@dataclasses.dataclass
class Sharder:
    """Resolves logical axis names to PartitionSpecs for one mesh.

    ``mesh=None`` → all placement methods are identities (one device).
    """

    mesh: Any = None
    rules: dict[str, list[Any]] | None = None

    def __post_init__(self):
        merged = dict(DEFAULT_RULES)
        merged.update(self.rules or {})
        self.rules = merged
        if self.mesh is not None:
            self._axis_sizes = dict(zip(*_mesh_axes(self.mesh)))
        else:
            self._axis_sizes = {}

    # ------------------------------------------------------------------ api
    def spec(self, shape: Sequence[int], logical: Sequence[str | None]
             ) -> PartitionSpec:
        """PartitionSpec for a tensor of ``shape`` with logical dim names."""
        if len(shape) != len(logical):
            raise ValueError(f"shape {tuple(shape)} vs logical {logical}")
        used: set[str] = set()
        return P(*[self._resolve(dim, name, used)
                   for dim, name in zip(shape, logical)])

    def _resolve(self, dim: int, name: str | None, used: set[str]):
        for cand in self.rules.get(name, []):
            axes = (cand,) if isinstance(cand, str) else tuple(cand)
            if not all(a in self._axis_sizes for a in axes):
                continue
            if any(a in used for a in axes):
                continue
            size = int(np.prod([self._axis_sizes[a] for a in axes]))
            if size <= 1 or dim % size != 0:
                continue
            used.update(axes)
            return axes if len(axes) > 1 else axes[0]
        return None

    def sharding(self, shape, logical) -> NamedSharding | None:
        if self.mesh is None:
            return None
        spec = self.spec(shape, logical)
        return NamedSharding(self.mesh, spec,
                             spec_placements(self.mesh, spec))

    def act(self, x, logical: Sequence[str | None]):
        """A sharding constraint on an activation: a differentiable
        ``redistribute`` to the spec's placements (identity without a
        mesh).  A plain tensor is read as replicated."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor, Replicate
        tgt = spec_placements(self.mesh, self.spec(x.shape, logical))
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh,
                                   (Replicate(),) * self.mesh.ndim,
                                   run_check=False)
        return _Contiguous.apply(_Contiguous.apply(x).redistribute(
            self.mesh, tgt))

    def shard_params(self, params, axes_tree):
        """Every leaf of ``params`` (the same whole tensors on every rank)
        placed per its logical axes."""
        if self.mesh is None:
            return params
        return tree_map(lambda p, ax: place(p, self.sharding(p.shape, ax)),
                        params, axes_tree)

    def param_shardings(self, shapes_tree, axes_tree):
        """The NamedSharding of every leaf of ``shapes_tree`` (anything
        with a ``shape``); None for every leaf without a mesh."""
        if self.mesh is None:
            return tree_map(lambda s: None, shapes_tree)
        return tree_map(lambda s, ax: self.sharding(s.shape, ax),
                        shapes_tree, axes_tree)

    def zeros(self, shape, logical, dtype, device):
        """A zero tensor placed per its logical axes: a DTensor on the
        mesh's device (each rank allocates only its block), or a plain
        tensor on ``device`` without a mesh."""
        sh = self.sharding(shape, logical)
        if sh is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        from torch.distributed import tensor as dt
        return dt.zeros(tuple(shape), dtype=dtype, device_mesh=self.mesh,
                        placements=sh.placements)

    def spec_tensor(self, shape, logical, dtype):
        """A ``meta`` tensor (shape and dtype, no allocation) whose
        ``sharding`` attribute is its NamedSharding (None without a mesh):
        the counterpart of a ``ShapeDtypeStruct`` with a sharding."""
        t = torch.empty(tuple(shape), dtype=dtype, device="meta")
        t.sharding = self.sharding(shape, logical)
        return t

    def scope(self):
        """Context for model code on a mesh: plain tensors made inside it
        (positions, masks, zeros) combine with DTensors as replicated
        values; nothing without a mesh.  Scopes nest (only the outermost
        switches DTensor's thread-local flag, which ``implicit_replication``
        clears on exit); a backward started inside one runs under it."""
        if self.mesh is None or getattr(_SCOPE, "depth", 0):
            return contextlib.nullcontext()
        return _outer_scope()


class _Contiguous(torch.autograd.Function):
    """``x.contiguous()``, and its gradient made contiguous too.

    A redistribution that gathers builds a contiguous local block, while
    the DTensor keeps the global strides of its input; a permuted input
    (an einsum's output) then carries a block whose layout its strides do
    not describe, and a later view of it fails on the block.  ``act``
    passes its value through this on both sides of the redistribution, so
    that the gradient's redistribution sees a contiguous tensor too."""

    @staticmethod
    def forward(ctx, x):
        return x.contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


_SCOPE = threading.local()


@contextlib.contextmanager
def _outer_scope():
    from torch.distributed.tensor.experimental import implicit_replication
    _SCOPE.depth = 1
    try:
        with implicit_replication():
            yield
    finally:
        _SCOPE.depth = 0


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts / NamedTuples (``rest``
    trees of the same structure supply further arguments)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, getattr(tree, k),
                                     *[getattr(r, k) for r in rest])
                            for k in tree._fields])
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts / NamedTuples in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if hasattr(tree, "_fields"):
        return [x for k in tree._fields for x in tree_leaves(getattr(tree, k))]
    return [tree]


class AxTree:
    """Helper to build a params tree together with its logical-axes tree."""

    def __init__(self):
        self.params: dict = {}
        self.axes: dict = {}

    def add(self, name: str, value, logical: tuple):
        if len(logical) != value.ndim:
            raise ValueError(f"{name}: logical {logical} vs shape "
                             f"{tuple(value.shape)}")
        self.params[name] = value
        self.axes[name] = logical
        return value

    def sub(self, name: str, tree: "AxTree | tuple"):
        if isinstance(tree, AxTree):
            self.params[name] = tree.params
            self.axes[name] = tree.axes
        else:
            params, axes = tree
            self.params[name] = params
            self.axes[name] = axes

    def build(self):
        return self.params, self.axes
