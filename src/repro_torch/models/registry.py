"""Family → model API dispatch (port of ``repro/models/registry.py``)."""
from __future__ import annotations

import functools

from repro_torch.parallel.sharding import Sharder


def _scoped(shd: Sharder, fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with shd.scope():
            return fn(*args, **kwargs)
    return run


def get_api(cfg, shd: Sharder | None = None, device=None):
    """The LM API of ``cfg.family``.  ``device`` is where ``init_cache``
    puts caches (``None`` → CUDA, raising without a GPU; ``"cpu"`` for
    the CPU; on a mesh, the mesh's device); ``init(key)`` draws on the
    generator's device, or gives ``meta`` tensors for ``key=None``.  On a
    mesh, ``loss``, ``prefill`` and ``decode_step`` run under
    ``shd.scope()``; a caller that differentiates ``loss`` runs the
    backward under it too (``launch.steps`` does)."""
    shd = shd or Sharder(mesh=None)
    api = _family_api(cfg, shd, device)
    if shd.mesh is None:
        return api
    return api._replace(loss=_scoped(shd, api.loss),
                        prefill=_scoped(shd, api.prefill),
                        decode_step=_scoped(shd, api.decode_step))


def _family_api(cfg, shd: Sharder, device):
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer
        return transformer.make_api(cfg, shd, device)
    if cfg.family == "ssm":
        from repro_torch.models import mamba2
        return mamba2.make_api(cfg, shd, device)
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid
        return hybrid.make_api(cfg, shd, device)
    if cfg.family == "audio":
        from repro_torch.models import encdec
        return encdec.make_api(cfg, shd, device)
    raise ValueError(f"no LM api for family {cfg.family!r} "
                     f"(kws uses repro_torch.models.kws directly)")
