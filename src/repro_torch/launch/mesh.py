"""Device meshes: the LM mesh and the slot mesh of the sharded KWS engine.

Port of ``repro/launch/mesh.py``.  The LM mesh is a
``torch.distributed.DeviceMesh`` over an initialised process group, one
process per rank (the reference's one controller over many devices
becomes SPMD processes): ``make_host_mesh(model)`` is ``(world // model,
model)`` with the axes ``("data", "model")``, ``make_production_mesh``
the reference's ``(16, 16)`` / ``(2, 16, 16)`` with ``("pod", "data",
"model")``.  ``run_ranks(fn, n)`` runs a function on ``n`` spawned ranks
(gloo for CPU tensors, NCCL on cards, a ``file://`` store, no TCP port):
the counterpart of the reference's ``host_device_flags`` split of a host.
NCCL takes one rank per card, so ``n`` ranks on cards need ``n`` cards.
The reference's v5e constants describe a TPU and are not ported.

The slot mesh (DESIGN.md §6), ``make_slot_mesh``:  The sharded engine
partitions its SLOT axis (one live audio stream per slot) over a 1-D mesh
with the one axis ``"data"``; weights are replicated, so the mesh never
needs a ``"model"`` axis.  One Python process drives every shard, as the
reference's ``shard_map`` does: shard ``i`` runs on ``devices[i]`` and, on
a card, on a CUDA stream of its own (``stream(i)``), created at first use.

``make_slot_mesh(n)`` takes the first ``n`` visible cards, one shard per
card.  ``SlotMesh.on(device, n)`` puts ``n`` shards on ONE device, the
counterpart of the reference's virtual host devices (its
``host_device_flags`` split of a CPU host): ``on("cpu", n)`` serves the
CPU tests and ``serve --devices N --device cpu``, and ``on("cuda:0", 2)``
holds two shards, each on its own stream, on one card.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import tempfile
import uuid

import numpy as np
import torch


class SlotMesh:
    """An ordered list of ``torch.device``s with the one axis ``"data"``.

    ``axis_names``, ``devices`` (a 1-D object array) and ``shape["data"]``
    are the attributes ``parallel.sharding.slot_shards`` and ``Sharder``
    read.  Devices may repeat (several shards on one device); they are
    all CUDA devices or all the CPU."""

    axis_names = ("data",)

    def __init__(self, devices):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a slot mesh needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"a slot mesh is all CUDA devices or all the "
                             f"CPU, got {[str(d) for d in devs]}")
        if "cuda" in kinds and torch.cuda.is_available():
            devs = [torch.device("cuda", torch.cuda.current_device()
                                 if d.index is None else d.index)
                    for d in devs]
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.shape = {"data": len(devs)}
        self._streams: list | None = None

    @classmethod
    def on(cls, device, n: int) -> "SlotMesh":
        """``n`` shards on one ``device`` (each on its own CUDA stream on
        a card)."""
        if n < 1:
            raise ValueError(f"shard count must be >= 1, got {n}")
        return cls([device] * n)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    def device(self, i: int) -> torch.device:
        return self.devices[i]

    def stream(self, i: int):
        """Shard ``i``'s CUDA stream (None on the CPU)."""
        if not self.is_cuda:
            return None
        if self._streams is None:
            self._streams = [torch.cuda.Stream(device=d)
                             for d in self.devices]
        return self._streams[i]

    def shard(self, i: int):
        """Context: shard ``i``'s device guard and stream (nothing on the
        CPU)."""
        if not self.is_cuda:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.devices[i]))
        stack.enter_context(torch.cuda.stream(self.stream(i)))
        return stack

    def __repr__(self):
        return f"SlotMesh({[str(d) for d in self.devices]})"


def make_slot_mesh(devices: int | None = None) -> SlotMesh | None:
    """1-D ``("data",)`` mesh over the first ``devices`` visible cards, one
    shard per card (``None``: every visible card).

    Returns ``None`` for one device: the unsharded session IS the
    one-shard engine.  Raises ``ValueError`` below 1 and beyond the
    visible cards (``SlotMesh.on`` puts several shards on one device)."""
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(avail, 1) if devices is None else devices
    if n < 1:
        raise ValueError(f"device count must be >= 1, got {n}")
    if n == 1:
        return None
    if n > avail:
        raise ValueError(f"asked for {n} devices, only {avail} visible "
                         f"(several shards on one device: "
                         f"SlotMesh.on(device, {n}))")
    return SlotMesh([torch.device("cuda", i) for i in range(n)])


# ------------------------------------------------------------- the LM mesh
def _world() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("an LM mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or "
                           "run_ranks)")
    return dist.get_world_size()


def make_host_mesh(model: int = 1, device: str = "cuda"):
    """``DeviceMesh`` of shape ``(world // model, model)``, axes
    ``("data", "model")``, over the initialised process group; on CUDA
    unless the caller asks for ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    world = _world()
    if model < 1 or world % model:
        raise ValueError(f"model axis {model} does not divide the world "
                         f"size {world}")
    return init_device_mesh(device, (world // model, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The reference's production mesh: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``.
    Raises ``ValueError`` unless the world size is 256 / 512."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world, need = _world(), int(np.prod(shape))
    if world != need:
        raise ValueError(f"the {'multi-pod' if multi_pod else 'single-pod'} "
                         f"production mesh {shape} needs {need} ranks, the "
                         f"process group has {world}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def _rank_main(rank, fn, n, args, device, workdir, store):
    import torch.distributed as dist
    if device == "cuda":
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=rank, world_size=n,
                                device_id=torch.device("cuda", rank))
    else:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=n)
    try:
        out = fn(rank, n, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, *args, device: str = "cpu",
              workdir: str | os.PathLike | None = None) -> list:
    """``fn(rank, n, *args)`` on ``n`` spawned processes joined in one
    process group (gloo on the CPU, one threaded; NCCL with rank ``r`` on
    card ``r``), over a ``file://`` store under ``workdir`` (a fresh
    temporary directory by default).  Returns each rank's return value
    (``torch.save``-able), in rank order; a rank that raises fails the
    call.  ``fn`` must be importable by name (a module-level function)."""
    import torch.multiprocessing as mp
    if device == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"{n} NCCL ranks need {n} cards, "
                         f"{torch.cuda.device_count()} visible (NCCL "
                         f"refuses two ranks on one card)")
    with contextlib.ExitStack() as stack:
        if workdir is None:
            workdir = stack.enter_context(tempfile.TemporaryDirectory())
        workdir = pathlib.Path(workdir)
        workdir.mkdir(parents=True, exist_ok=True)
        store = workdir / f"store_{uuid.uuid4().hex}"
        mp.spawn(_rank_main, args=(fn, n, args, device, str(workdir),
                                   str(store)), nprocs=n, join=True)
        return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
                for r in range(n)]
