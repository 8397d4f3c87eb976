"""Atomic, restorable checkpoints of tensor trees.

Port of ``repro/train/checkpoint.py`` with its on-disk format:

    ckpt_dir/step_00000123.tmp/...   (written)
    ckpt_dir/step_00000123/          (atomic rename when complete)
        meta.json                    (step, keys, dtypes, extra)
        arrays.npz                   (flat {path: np.ndarray})

Keys are the tree's paths joined by "/" (dict keys, NamedTuple fields,
list indices), so a checkpoint written by either package restores in the
other: ``{"params": ..., "opt": AdamWState}`` flattens to ``params/w_x``,
``opt/step``, ``opt/master/w_x``, ….  A crashed writer leaves a ``.tmp``
directory or a step directory without ``meta.json``; ``latest_step``
ignores both.  bfloat16 leaves are stored as float32 (npz has no
bfloat16) and cast back on restore.

On an LM mesh every rank calls ``save``: each DTensor leaf's whole value
is gathered, rank 0 writes, the mesh's shape and axes go into
``meta.json``, and the ranks meet at a barrier.  ``restore(...,
shardings=)`` places each leaf per its target NamedSharding, on any mesh
(the elastic rescale); a DTensor like-leaf without a target keeps its
own placement.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil

import numpy as np
import torch

from repro_torch.parallel.sharding import NamedSharding, is_dtensor, place


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):                       # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def leaves(tree) -> list:
    """The tree's leaves in ``_flatten`` order."""
    return list(_flatten(tree).values())


def _to_numpy(v) -> tuple[np.ndarray, str]:
    """(npz-safe array, the leaf's dtype name)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.to(torch.float32).numpy(), "bfloat16"
        a = v.numpy()
    else:
        a = np.asarray(v)
    return a, str(a.dtype)


def save(ckpt_dir: str | pathlib.Path, step: int, tree,
         extra: dict | None = None) -> pathlib.Path:
    """Write ``tree`` as step ``step``: into ``step_%08d.tmp``, then one
    rename.  Returns the final directory."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    final = ckpt_dir / f"step_{step:08d}"
    flat, mesh = {}, None
    for k, v in _flatten(tree).items():
        if is_dtensor(v):                     # a collective: every rank
            mesh = mesh or v.device_mesh
            v = v.full_tensor()
        flat[k] = v
    if mesh is None or torch.distributed.get_rank() == 0:
        _write(tmp, final, step, flat, extra, mesh)
    if mesh is not None:
        torch.distributed.barrier()
    return final


def _write(tmp, final, step, flat, extra, mesh):
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays, dtypes = {}, {}
    for k, v in flat.items():
        arrays[k], dtypes[k] = _to_numpy(v)
    np.savez(tmp / "arrays.npz", **arrays)
    meta = {"step": step, "keys": sorted(arrays.keys()), "dtypes": dtypes,
            "extra": extra or {},
            "mesh": None if mesh is None else {
                "shape": [int(n) for n in mesh.shape],
                "axes": list(mesh.mesh_dim_names)}}
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                                    # atomic commit


def latest_step(ckpt_dir: str | pathlib.Path) -> int | None:
    """The newest complete step under ``ckpt_dir`` (None if none)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "meta.json").exists():
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str | pathlib.Path, step: int, like_tree,
            shardings=None):
    """Restore step ``step`` into the structure of ``like_tree``: each
    leaf takes its like-leaf's dtype and device (a non-tensor leaf comes
    back as a CPU tensor of its numpy dtype).  ``shardings``, a tree like
    ``like_tree`` of NamedShardings (or None leaves), re-places each leaf
    on its target mesh: the elastic-rescale path."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}" / "arrays.npz"
    flat_sh = _flatten(shardings) if shardings is not None else {}
    restored = {}
    with np.load(path) as data:
        for k, leaf in _flatten(like_tree).items():
            t = torch.from_numpy(np.array(data[k]))
            if not isinstance(leaf, torch.Tensor):
                leaf = torch.from_numpy(np.asarray(leaf))
            sh = flat_sh.get(k)
            if sh is None and is_dtensor(leaf):
                sh = NamedSharding(leaf.device_mesh, None, leaf.placements)
            restored[k] = (place(t.to(leaf.dtype), sh) if sh is not None
                           else t.to(dtype=leaf.dtype, device=leaf.device))
    return _unflatten_like(like_tree, restored)


def _unflatten_like(tree, flat, prefix=""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[
            _unflatten_like(getattr(tree, k), flat, f"{prefix}{k}/")
            for k in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return flat[prefix.rstrip("/")]


def meta(ckpt_dir: str | pathlib.Path, step: int) -> dict:
    p = pathlib.Path(ckpt_dir) / f"step_{step:08d}" / "meta.json"
    return json.loads(p.read_text())
