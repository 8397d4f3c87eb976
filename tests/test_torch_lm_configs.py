"""The port's LM configs, cost model and logical-axis Sharder against the
JAX package's: every config field (full and smoke, the ten LM configs and
deltakws), the shapes and cells, ``param_count`` / ``step_costs`` for
every config and shape, ``Sharder.spec`` on fake meshes and the slot
partition's arithmetic — all exactly."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import costmodel as jcm
from repro.parallel import sharding as jshard
from repro_torch import configs as tconfigs
from repro_torch.launch import costmodel as tcm
from repro_torch.parallel import sharding as tshard

ALL_ARCHS = jconfigs.ARCH_IDS + ["deltakws"]


def _dtype_name(d) -> str:
    if isinstance(d, torch.dtype):
        return str(d).split(".")[-1]
    return np.dtype(d).name


def _fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = _dtype_name(v) if f.name == "dtype" else v
    return out


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_field_equals_the_reference(arch, smoke):
    get_j = jconfigs.get_smoke_config if smoke else jconfigs.get_config
    get_t = tconfigs.get_smoke_config if smoke else tconfigs.get_config
    j, t = get_j(arch), get_t(arch)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert _fields(t) == _fields(j)
    for prop in ("vocab_padded", "d_inner"):
        assert getattr(t, prop) == getattr(j, prop), prop
    if j.ssm_headdim:
        assert t.ssm_nheads == j.ssm_nheads
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16


def test_shapes_cells_and_helpers_equal_the_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    assert tconfigs.LM_SHAPES.keys() == jconfigs.LM_SHAPES.keys()
    for k, s in jconfigs.LM_SHAPES.items():
        assert dataclasses.asdict(tconfigs.LM_SHAPES[k]) == \
            dataclasses.asdict(s)
        assert tconfigs.LM_SHAPES[k].is_decode == s.is_decode
    for skipped in (False, True):
        assert tconfigs.cells(skipped) == jconfigs.cells(skipped)
    from repro.configs.base import pad_to as jpad
    from repro_torch.configs.base import pad_to as tpad
    for n in (1, 31, 32, 33, 151936, 256206):
        for m in (1, 32, 2048):
            assert tpad(n, m) == jpad(n, m)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_count_and_step_costs_equal_the_reference(arch):
    for get_j, get_t in ((jconfigs.get_config, tconfigs.get_config),
                         (jconfigs.get_smoke_config,
                          tconfigs.get_smoke_config)):
        j, t = get_j(arch), get_t(arch)
        for active in (False, True):
            for emb in (False, True):
                assert tcm.param_count(t, active_only=active,
                                       include_embed=emb) == \
                    jcm.param_count(j, active_only=active, include_embed=emb)
        assert t.n_params() == j.n_params()
        assert t.n_params_active() == j.n_params_active()
        if arch == "deltakws":
            continue
        for policy in ("full", "save_mlp"):
            jp = dataclasses.replace(j, remat_policy=policy)
            tp = dataclasses.replace(t, remat_policy=policy)
            for name, shape in jconfigs.LM_SHAPES.items():
                jc = jcm.step_costs(jp, shape)
                tc = tcm.step_costs(tp, tconfigs.LM_SHAPES[name])
                assert dataclasses.asdict(tc) == dataclasses.asdict(jc), \
                    (arch, name, policy)


def test_full_width_param_counts_of_the_card_phase():
    """The counts the card phase prints for its three full-width models."""
    got = {a: tcm.param_count(tconfigs.get_config(a)) for a in
           ("qwen2-0.5b", "mamba2-370m", "granite-moe-3b-a800m")}
    assert got == {a: jcm.param_count(jconfigs.get_config(a)) for a in got}
    assert round(got["qwen2-0.5b"] / 1e6, 1) == 633.1
    assert round(got["mamba2-370m"] / 1e6, 1) == 421.7
    assert round(got["granite-moe-3b-a800m"] / 1e6, 1) == 3380.6


class FakeMesh:
    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


def _spec_tuple(spec):
    return tuple(spec)


MESHES = [(("data", "model"), (4, 2)), (("pod", "data", "model"), (2, 4, 2)),
          (("pod", "data", "model"), (2, 16, 16)), (("data",), (8,))]
CASES = [((8, 6), ("batch", "mlp")), ((7, 5), ("batch", "mlp")),
         ((8, 8), ("batch", "kv_seq")), ((64, 32, 14, 64),
                                        ("batch", "seq", "heads", None)),
         ((151936, 896), ("vocab", "embed")), ((24, 896, 14, 64),
                                               ("layers", "embed", "heads",
                                                "head_dim")),
         ((40, 1536, 512), ("expert", "embed", "mlp")),
         ((32, 4096, 8, 128), ("batch", "kv_seq", "kv_heads", "head_dim")),
         ((256, 2), ("slots", None)), ((3,), ("unknown_axis",))]


@pytest.mark.parametrize("names,shape", MESHES,
                         ids=["data4xmodel2", "pod2xdata4xmodel2",
                              "pod2xdata16xmodel16", "data8"])
def test_sharder_spec_equals_the_reference(names, shape):
    mesh = FakeMesh(names, shape)
    for rules in (None, jshard.DECODE_RULES):
        js = jshard.Sharder.__new__(jshard.Sharder)
        js.mesh, js.rules = mesh, dict(jshard.DEFAULT_RULES)
        js.rules.update(rules or {})
        js._axis_sizes = dict(zip(names, shape))
        ts = tshard.Sharder(mesh=mesh, rules=tshard.DECODE_RULES
                            if rules else None)
        for shp, logical in CASES:
            assert _spec_tuple(ts.spec(shp, logical)) == \
                _spec_tuple(js.spec(shp, logical)), (shp, logical)
    assert tshard.DEFAULT_RULES == jshard.DEFAULT_RULES
    assert tshard.DECODE_RULES == jshard.DECODE_RULES


def test_sharder_reference_cases_and_single_device_identities():
    """The reference's own FakeMesh cases, and ``mesh=None`` identities;
    on a ``DeviceMesh`` (a fake process group of 8 ranks, (4, 2)) the
    placement methods give DTensors and NamedShardings per the spec, and
    ``tp_down_proj`` runs."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    import _torch_lm_mesh as H
    mesh = FakeMesh(("data", "model"), (4, 2))
    s = tshard.Sharder(mesh=mesh)
    assert s.spec((8, 6), ("batch", "mlp")) == tshard.P("data", "model")
    assert s.spec((7, 5), ("batch", "mlp")) == tshard.P(None, None)
    assert s.spec((8, 8), ("batch", "kv_seq")) == tshard.P("data", "model")
    x = torch.ones(8, 6)
    with H.fake_world(8):
        dm = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        s = tshard.Sharder(mesh=dm)
        assert s.spec((8, 6), ("batch", "mlp")) == tshard.P("data", "model")
        sh = s.sharding((8, 6), ("batch", "mlp"))
        assert sh.spec == tshard.P("data", "model")
        assert sh.placements == (Shard(0), Shard(1)) and sh.mesh is dm
        y = s.act(x, ("batch", None))
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == (Shard(0), Replicate())
        assert tuple(y.to_local().shape) == (2, 6)
        p = s.shard_params({"a": {"w": x}}, {"a": {"w": ("batch", "mlp")}})
        assert tuple(p["a"]["w"].placements) == (Shard(0), Shard(1))
        assert torch.equal(p["a"]["w"].to_local(), x[:2, :3])
        got = s.param_shardings({"a": {"w": x}}, {"a": {"w": ("batch",
                                                             "mlp")}})
        assert got == {"a": {"w": sh}}
        from repro_torch.models import layers as L
        with s.scope():
            out = L.tp_down_proj(torch.ones(1, 2, 3), torch.ones(3, 4), s,
                                 "bsf,fd->bsd", ("batch", "seq", "act_mlp"),
                                 ("mlp", "embed"))
        assert isinstance(out, DTensor) and tuple(out.shape) == (1, 2, 4)
    one = tshard.Sharder(mesh=None)
    assert one.act(x, ("batch", None)) is x
    assert one.sharding((2, 3), ("batch", None)) is None
    p = {"a": {"w": x}}
    assert one.shard_params(p, {"a": {"w": ("batch", None)}}) is p
    assert one.param_shardings(p, {"a": {"w": ("batch", None)}}) == \
        {"a": {"w": None}}
    t = tshard.AxTree()
    t.add("w", x, ("embed", "mlp"))
    with pytest.raises(ValueError):
        t.add("v", x, ("embed",))


@pytest.mark.parametrize("data", [1, 2, 4, 8])
def test_check_slot_partition_equals_the_reference(data):
    jm = FakeMesh(("data", "model"), (data, 2))
    jm.shape = {"data": data, "model": 2}          # jax Mesh.shape
    tm = FakeMesh(("data", "model"), (data, 2))
    assert tshard.slot_shards(tm) == jshard.slot_shards(jm) == data
    assert tshard.slot_shards(None) == jshard.slot_shards(None) == 1
    for n in range(1, 20):
        try:
            want = jshard.check_slot_partition(jm, n)
        except ValueError:
            with pytest.raises(ValueError, match="do not partition"):
                tshard.check_slot_partition(tm, n)
        else:
            assert tshard.check_slot_partition(tm, n) == want
    bad = FakeMesh(("model",), (2,))
    with pytest.raises(ValueError, match="'data' axis"):
        tshard.slot_shards(bad)
