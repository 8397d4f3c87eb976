"""The LM mesh's placement and collectives in one process (a ``fake``
process group: collectives are counted by ``CommDebugMode``, not run),
and one float32 loss of each other family on 4 gloo ranks against the
JAX package run unsharded.

Fake-group cases: the production meshes' shapes and names; the
reference's ``(2, 2, 2)`` multi-pod case (its spec, and that the
gradient of its loss issues an all-reduce or a reduce-scatter); a joint
``("pod", "data")`` shard's rows on each of the 8 ranks; one
``tp_down_proj`` call on the reduce-scatter path (exactly one
reduce-scatter, over ``'model'``, and no all-reduce) and its three
fallbacks (no reduce-scatter).  Gloo case: the MoE, mamba2, zamba2 and
seamless smoke configs on ``(2, 2)``, float32 loss within 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_mesh as H

F32_TOL = 1e-4


def test_production_meshes_shapes_and_names():
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    with H.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        assert tuple(mesh.shape) == (16, 16)
        assert mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(ValueError, match="needs 512 ranks"):
            make_production_mesh(multi_pod=True, device="cpu")
        host = make_host_mesh(model=4, device="cpu")
        assert tuple(host.shape) == (64, 4)
        assert host.mesh_dim_names == ("data", "model")
        with pytest.raises(ValueError, match="does not divide"):
            make_host_mesh(model=3, device="cpu")
    with H.fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        assert tuple(mesh.shape) == (2, 16, 16)
        assert mesh.mesh_dim_names == ("pod", "data", "model")


def test_multipod_spec_and_gradient_issue_a_reduction():
    """The reference's MULTIPOD_COLLECTIVES on (2, 2, 2)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.parallel.sharding import P, Sharder, place
    with H.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        shd = Sharder(mesh=mesh)
        assert shd.spec((8, 16), ("batch", "mlp")) == P(("pod", "data"),
                                                        "model")
        w_sh = shd.sharding((16, 16), ("embed", "mlp"))
        w = place(torch.ones(16, 16, dtype=torch.bfloat16), w_sh)
        x = place(torch.ones(8, 16, dtype=torch.bfloat16),
                  shd.sharding((8, 16), ("batch", None)))
        w = w.detach().requires_grad_(True)
        with shd.scope(), CommDebugMode() as cm:
            loss = torch.sum(torch.tanh(x @ w) ** 2)
            loss = loss.redistribute(mesh, shd.sharding((), ()).placements)
            (g,) = torch.autograd.grad(loss, [w])
            g = place(g, w_sh)
        counts = H.comm_counts(cm)
        assert counts.get("all_reduce", 0) + counts.get(
            "reduce_scatter_tensor", 0) > 0, counts
        assert tuple(g.placements) == w_sh.placements


@pytest.mark.parametrize("rank", range(8))
def test_joint_axis_shard_rows_on_each_rank(rank):
    """P(("pod", "data"), None) on (2, 2, 2): rank (pod p, data d, model
    m) holds rows block p·2 + d (the reference's major-to-minor order),
    whatever its model coordinate."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.sharding import Sharder, local_bounds, place
    with H.fake_world(8, rank):
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        shd = Sharder(mesh=mesh)
        x = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
        dt = place(x, shd.sharding((16, 3), ("batch", None)))
        p, d, _ = mesh.get_coordinate()
        block = p * 2 + d
        assert torch.equal(dt.to_local(), x[block * 4:(block + 1) * 4])
        assert local_bounds(dt, 0) == (block * 4, (block + 1) * 4)


def _tp_case(shd, B, S, h_logical, w_logical=("mlp", "embed")):
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import place
    from torch.distributed.tensor.debug import CommDebugMode
    h = place(torch.randn(B, S, 16), shd.sharding((B, S, 16), h_logical))
    w = place(torch.randn(16, 8), shd.sharding((16, 8), w_logical))
    with shd.scope(), CommDebugMode() as cm:
        out = L.tp_down_proj(h, w, shd, "bsf,fd->bsd", h_logical, w_logical)
    return out, H.comm_counts(cm)


def test_tp_down_proj_reduce_scatter_and_fallbacks():
    """On (2, 2): one reduce-scatter over 'model' onto the sequence and
    no all-reduce (the weight's FSDP 'data' axis is all-gathered); a
    one-token step, a sequence 'model' does not divide and a contraction
    not sharded on 'model' fall back to the plain einsum: no
    reduce-scatter."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard
    from repro_torch.parallel.sharding import Sharder
    with H.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        shd = Sharder(mesh=mesh)
        logical = ("batch", "seq", "act_mlp")
        out, counts = _tp_case(shd, 4, 8, logical)
        assert counts.get("reduce_scatter_tensor") == 1, counts
        assert counts.get("all_reduce", 0) == 0, counts
        assert tuple(out.placements) == (Shard(0), Shard(1))
        assert tuple(out.shape) == (4, 8, 8)
        for B, S, lg, wl in ((4, 1, logical, ("mlp", "embed")),
                             (4, 7, logical, ("mlp", "embed")),
                             (4, 8, ("batch", "seq", None), (None, None))):
            out, counts = _tp_case(shd, B, S, lg, wl)
            assert counts.get("reduce_scatter_tensor", 0) == 0, (S, counts)
            assert tuple(out.shape) == (B, S, 8)


# --------------------------------- the 256-rank production mesh
@pytest.mark.parametrize("arch", ["qwen3-32b", "mamba2-370m"])
def test_train_step_traces_on_the_production_mesh(arch):
    """Faults of the steps on (16, 16), traced on fake tensors (the
    dry-run's core): qwen3-32b's smoke config, whose 4 heads and 2 KV
    heads the 16-wide 'model' axis does not divide, failed at the view of
    its q/k/v products into heads; mamba2-370m's at its input projection,
    whose batch- and sequence-split input flattened into a strided split
    whose propagation read a value on the host."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, "train_4k", "single", device="cpu",
                          smoke=True)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["collectives"]["count"] > 0


# ------------------------------- the other families on 4 gloo ranks
def test_family_losses_sharded_against_jax(tmp_path):
    """The MoE, mamba2, zamba2 hybrid and seamless enc-dec smoke configs:
    one float32 loss each on (2, 2) within 1e-4 of JAX's, unsharded."""
    import dataclasses
    from repro.configs import get_smoke_config
    from repro.models import get_api
    from repro.parallel.sharding import Sharder
    from repro_torch.launch.mesh import run_ranks
    refs, want = {}, {}
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        for i, arch in enumerate(H.FAMILY_ARCHS):
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      dtype=jnp.float32)
            api = get_api(cfg, Sharder())
            params, _ = api.init(jax.random.PRNGKey(0))
            toks = H.np_tokens(cfg.vocab_size, i + 1)
            batch = {"tokens": toks[:, :H.S], "labels": toks[:, 1:]}
            if cfg.frontend != "none":
                batch["embeds"] = np.random.default_rng(i).standard_normal(
                    (H.B, cfg.frontend_tokens, cfg.d_model)).astype(
                        np.float32)
            loss, _ = jax.jit(api.loss)(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
            want[arch] = float(loss)
            refs[arch] = (jax.tree.map(np.asarray, params), batch)
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)
        jax.clear_caches()
    ranks = run_ranks(H.family_rank, 4, refs, device="cpu", workdir=tmp_path)
    for arch in H.FAMILY_ARCHS:
        for r in ranks:
            assert abs(r[arch] - want[arch]) <= F32_TOL * abs(want[arch]), \
                (arch, r[arch], want[arch])
