"""The slot mesh of the sharded KWS serving engine (DESIGN.md §6).

Port of ``repro/launch/mesh.py::make_slot_mesh``.  The sharded engine
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

The LM meshes (``make_host_mesh``, ``make_production_mesh``) and the
reference's v5e constants are not here: see ROADMAP.md queue 1 item 9c.
"""
from __future__ import annotations

import contextlib

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
