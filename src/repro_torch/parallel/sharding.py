"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.

Port of ``repro/parallel/sharding.py``, its single-device half.  Every
tensor carries *logical* dimension names ("batch", "embed", "mlp",
"heads", ...).  A :class:`Sharder` resolves them to a ``PartitionSpec``
for a mesh:

  * each logical name has an ordered list of candidate mesh-axis tuples;
  * a candidate is accepted only if all its axes exist in the mesh, none is
    already used by an earlier dimension of the same tensor, and the dim is
    evenly divisible by the product of the axis sizes;
  * otherwise the next candidate is tried, ending at ``None`` (replicated).

``Sharder.spec`` is pure arithmetic over axis sizes: it takes any object
with ``axis_names`` and ``devices.shape``.  With ``mesh=None`` (one
device) ``act``, ``sharding``, ``shard_params`` and ``param_shardings``
are identities, as in the reference.  Placing an LM tensor on a real mesh
is ROADMAP.md queue 1 item 9c (the LM mesh) and raises
``NotImplementedError`` until then.

The slot axis of the sharded KWS engine (DESIGN.md §6) is ported: on a
``launch.mesh.SlotMesh`` a sharded value is a list with one entry per
shard.  ``put_slot_sharded`` gives shard ``i`` the contiguous block of
rows ``[i·B/n, (i+1)·B/n)`` of every leaf on its device; ``put_replicated``
gives every shard the copy of its device (shards on one device share it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

MESH_TODO = ("placing tensors on an LM device mesh (DTensor on a "
             "DeviceMesh) is ROADMAP.md queue 1 item 9c (the LM mesh)")


class PartitionSpec(tuple):
    """A tuple of per-dimension mesh axes (an axis name, a tuple of axis
    names, or None = replicated), compared as a tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

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
            self._axis_sizes = dict(zip(self.mesh.axis_names,
                                        self.mesh.devices.shape))
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

    def sharding(self, shape, logical):
        if self.mesh is None:
            return None
        raise NotImplementedError(f"Sharder.sharding: {MESH_TODO}")

    def act(self, x, logical: Sequence[str | None]):
        """A sharding constraint on an activation (identity without a
        mesh)."""
        if self.mesh is None:
            return x
        raise NotImplementedError(f"Sharder.act: {MESH_TODO}")

    def shard_params(self, params, axes_tree):
        if self.mesh is None:
            return params
        raise NotImplementedError(f"Sharder.shard_params: {MESH_TODO}")

    def param_shardings(self, shapes_tree, axes_tree):
        """None for every leaf of ``shapes_tree`` without a mesh."""
        if self.mesh is None:
            return tree_map(lambda s: None, shapes_tree)
        raise NotImplementedError(f"Sharder.param_shardings: {MESH_TODO}")


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
