"""Device resolution for the port's entry points.

Entry points run on the GPU by default.  ``resolve_device(None)`` means
CUDA and raises when CUDA is missing: there is no silent CPU fallback, so
a CPU number can never pass for a GPU number.  Tests pass
``device="cpu"`` explicitly, which runs every kernel wrapper through its
plain PyTorch version (a wrapper picks the plain version only because its
tensor lies on the CPU).

The resolved device is logged once per distinct device, with the card's
name.

``refuse_grad`` is the kernels' autograd contract: no kernel of the port
has a backward (no Pallas kernel of the reference has one either), so a
wrapper handed a tensor that needs a gradient raises instead of
returning a result that would silently drop it.

Mesh interplay (DESIGN.md §6): the sharded serving engine runs its pure
chunk steps once per shard of a slot mesh (``launch.mesh.SlotMesh``).
``shard_map_kernels`` is the one place that does it, the counterpart of
the reference's ``shard_map``: shard ``i``'s step is the single-device
step on its contiguous block of slots, launched on ``devices[i]`` under
that device's guard and on shard ``i``'s own CUDA stream, so every kernel
wrapper launches on that stream (they launch on the current stream of
their tensors' device).  The kernels are per stream along the slot axis,
so each shard's outputs are the unsharded step's rows bit for bit.  The
results are joined on the mesh's first device by ``join_slots``, whose
stream waits on each shard's stream through an event: the host never
waits.  There is no fallback: a CUDA shard launches its kernels or
raises, and a mesh of CUDA devices never runs a shard on the CPU.
"""
from __future__ import annotations

import logging

import torch

from repro_torch.parallel.sharding import map_tensors, tensors_of

_log = logging.getLogger(__name__)
_logged: set[str] = set()


def _configure_cuda_numerics() -> None:
    # The float path is full fp32: the FC product and any other float32
    # matmul or convolution must not drop to TF32 (about 3 decimal
    # digits), or the port would drift from the fp32 reference.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises without a GPU); otherwise the device
    asked for, checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions of the kernels on the CPU")
        _configure_cuda_numerics()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        name = torch.cuda.get_device_name(dev)
    elif dev.type == "cpu":
        name = "cpu (plain PyTorch versions of the kernels)"
    else:
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    key = str(dev)
    if key not in _logged:
        _logged.add(key)
        _log.info("repro_torch device: %s [%s]", key, name)
    return dev


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``ValueError`` if grad mode is on and any of ``tensors``
    requires a gradient: ``kernel`` has no backward.  Training runs the
    differentiable eager path (``delta_gru_scan(backend="xla")``)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise ValueError(
            f"{kernel} has no backward, and an input requires a gradient: "
            f"train through the differentiable backend='xla' (the eager "
            f"DeltaGRUCell loop), or run under torch.no_grad()")


def _zip_leaves(fn, parts):
    """``fn(*leaves)`` over the same leaf of every tree of ``parts``
    (NamedTuples and tensors; a None leaf stays None)."""
    first = parts[0]
    if first is None:
        return None
    if hasattr(first, "_fields"):
        return type(first)(*[_zip_leaves(fn, [p[k] for p in parts])
                             for k in range(len(first))])
    return fn(*parts)


def join_slots(mesh, parts, axis: int):
    """The shards' trees ``parts`` (one per shard, on its device) joined
    leaf by leaf on the slot ``axis`` on the mesh's first device.

    On a card the first device's current stream waits on each shard's
    stream through an event, never on the host.  A shard's tensor on that
    device is marked in use by that stream (so its memory is not reused
    before the join has read it); one on another card is copied there on
    the shard's stream, which the first device's stream then waits for."""
    dev0 = mesh.device(0)
    cat = lambda *ts: torch.cat(ts, dim=axis)
    if not mesh.is_cuda:
        return _zip_leaves(cat, parts)
    main = torch.cuda.current_stream(dev0)
    local = []
    for i, part in enumerate(parts):
        main.wait_stream(mesh.stream(i))
        if mesh.device(i) == dev0:
            for t in tensors_of(part):
                t.record_stream(main)
            local.append(part)
        else:
            with mesh.shard(i):
                local.append(map_tensors(
                    lambda t: t.to(dev0, non_blocking=True), part))
    with torch.cuda.device(dev0):
        return _zip_leaves(cat, local)


def _blocks(args, positions, axis: int) -> set:
    """The sizes on ``axis`` of the tensors at ``positions`` (a tensor of
    lower rank, such as a shard's telemetry sum, has no slot axis)."""
    return {t.shape[axis] for pos in positions for part in args[pos]
            for t in tensors_of(part) if t.dim() > axis}


def shard_map_kernels(fn, mesh, *, slot_major, time_major,
                      n_state_out: int):
    """Run the pure chunk step ``fn`` once per shard of the slot mesh.

    The returned callable takes ``fn``'s positional arguments as lists with
    one entry per shard: at the ``slot_major`` positions (state trees,
    telemetry, raw audio) each shard's block of slots on axis 0, at the
    ``time_major`` positions (frame-major features) on axis 1, and at
    every other position (weights, coefficients) the shard's replica.
    Keyword arguments go to every shard unchanged.  Shard ``i``'s call
    runs on its device and stream (``mesh.shard(i)``) and is the
    single-device step at batch B/n: the blocks must all be one size.

    Outputs follow the reference's (state..., result, health) convention:
    the ``n_state_out`` slot-major outputs come back as per-shard lists,
    the time-major result (slots on axis 1) and the slot-major health
    mask joined on the mesh's first device (``join_slots``).  Without a
    mesh, ``fn`` itself: the unsharded step, byte for byte.
    """
    if mesh is None:
        return fn
    slot_major, time_major = tuple(slot_major), tuple(time_major)

    def run(*args, **kw):
        n = mesh.size
        if any(len(a) != n for a in args):
            raise ValueError(f"every argument needs one entry per shard "
                             f"({n})")
        blocks = _blocks(args, slot_major, 0) | _blocks(args, time_major, 1)
        if len(blocks) > 1:
            raise ValueError(f"the shards' slot blocks differ in size: "
                             f"{sorted(blocks)}")
        outs = []
        for i in range(n):
            with mesh.shard(i):
                outs.append(fn(*(a[i] for a in args), **kw))
        states = tuple([o[k] for o in outs] for k in range(n_state_out))
        result = join_slots(mesh, [o[n_state_out] for o in outs], axis=1)
        health = join_slots(mesh, [o[n_state_out + 1] for o in outs],
                            axis=0)
        return (*states, result, health)

    return run
