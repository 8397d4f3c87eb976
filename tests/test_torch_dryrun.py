"""The port's dry-run (``repro_torch.launch.dryrun``) and its collective
inventory (``repro_torch.launch.hlo_analysis``) against the JAX package's.

Accounting: ``shape_bytes`` and ``collective_summary`` equal the
reference's, exactly, on the reference's own strings and on the same
``CollectiveOp`` lists (its ``FAKE_HLO`` parse, and the same collectives
written as one record per call, the port's form).  Recorder: a hand-made
DTensor program on a ``fake`` world of 16 ranks at (4, 4) gives exact
bytes, participants and local FLOPs.  FLOPs: ``FlopCounterMode`` on the
reference test's unscanned matmul chain.  Smoke traces: ``run_cell`` at
smoke width on the CPU, one cell per family on the production meshes;
each ends ``ok``, carries every key of the reference's record, and its
analytic fields equal ``repro.launch.costmodel.step_costs`` exactly.
Against the reference's GSPMD placement: a smoke decode step on the
production mesh moves at most 2× the collective bytes of the reference's
compiled step (a subprocess with 512 host devices) and gathers no block
of its KV cache; a Mamba2 prefill and train step whose projection
columns split over 'model' at offsets that straddle the shards gather
none of the projection to split it.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.launch import hlo_analysis as ref_ha
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as ha

# The reference's FAKE_HLO (tests/test_costmodel_hlo.py): an all-gather
# inside a while loop of 24 trips and an all-reduce outside it.
FAKE_HLO = """
HloModule test

%body.1 (arg: (s32[], f32[128,256])) -> (s32[], f32[128,256]) {
  %p = (s32[], f32[128,256]) parameter(0)
  %ag = f32[128,256]{1,0} all-gather(%x), channel_id=1, replica_groups=[16,16]<=[256], dimensions={0}
  ROOT %t = (s32[], f32[128,256]) tuple(%i, %ag)
}

%cond.2 (arg: (s32[], f32[128,256])) -> pred[] {
  %p2 = (s32[], f32[128,256]) parameter(0)
  %c = s32[] constant(24)
  ROOT %lt = pred[] compare(%i2, %c), direction=LT
}

ENTRY %main.3 (a: f32[128,256]) -> f32[128,256] {
  %w = (s32[], f32[128,256]) while(%init), condition=%cond.2, body=%body.1
  %ar = f32[64,64]{1,0} all-reduce(%y), channel_id=2, replica_groups=[16,16]<=[256]
  ROOT %r = f32[128,256] get-tuple-element(%w), index=1
}
"""

# Every key of the reference's record (src/repro/launch/dryrun.py:83-105).
REF_KEYS = {"arch", "shape", "mesh", "chips", "status", "microbatches",
            "lower_s", "compile_s", "memory", "cost_analysis_flops",
            "collectives", "model_flops", "hlo_flops", "hbm_bytes",
            "tokens", "roofline"}
REF_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                   "alias_bytes", "per_device_total_gb", "fits_16gb"}
REF_ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                     "bound_s", "model_vs_hlo_flops"}


def _port_ops(ops):
    return [ha.CollectiveOp(**dataclasses.asdict(o)) for o in ops]


def _per_call(ops):
    """The reference's ops as the port records them: one record per call,
    multiplier 1."""
    return [ha.CollectiveOp(o.kind, o.bytes_per_device, o.participants,
                            1.0, o.computation)
            for o in ops for _ in range(int(o.multiplier))]


# ------------------------------------------------------------ accounting
@pytest.mark.parametrize("shape", [
    "f32[256,4096,320]", "bf16[16]", "(f32[4], s32[2])", "pred[3,5]",
    "s8[]", "(bf16[2,3]{1,0}, u64[7], c128[2])", "token[]",
    "f64[1,1,1]"])
def test_shape_bytes_equal_the_reference(shape):
    assert ha.shape_bytes(shape) == ref_ha.shape_bytes(shape)


@pytest.mark.parametrize("dtype,dims,want", [
    (torch.bfloat16, (16,), 32), (torch.float32, (256, 4096, 320),
                                  256 * 4096 * 320 * 4),
    (torch.int8, (), 1), (torch.float64, (3, 0), 0)])
def test_shape_bytes_of_a_torch_dtype(dtype, dims, want):
    assert ha.shape_bytes(dtype, dims) == want


@pytest.mark.parametrize("form", ["reference_ops", "per_call",
                                  "hand_made"])
def test_collective_summary_equals_the_reference(form):
    ref_ops = ref_ha.analyze_collectives(FAKE_HLO, total_devices=256)
    if form == "hand_made":
        ref_ops = [ref_ha.CollectiveOp(k, b, p, m, "c") for k, b, p, m in (
            ("reduce-scatter", 4096, 16, 3), ("all-to-all", 100, 2, 1),
            ("collective-permute", 7, 512, 2), ("all-reduce", 1, 1, 1))]
    want = ref_ha.collective_summary(ref_ops)
    if form == "per_call":
        got = ha.collective_summary(_per_call(ref_ops))
        assert got["total_bytes"] == want["total_bytes"]
        assert got["by_kind"] == want["by_kind"]
        assert got["count"] == 25            # calls, not distinct ops
        groups = ha.grouped(_per_call(ref_ops))
        assert sorted(g["calls"] for g in groups) == [1, 24]
    else:
        assert ha.collective_summary(_port_ops(ref_ops)) == want
        for a, b in zip(_port_ops(ref_ops), ref_ops):
            assert (a.factor, a.global_bytes) == (b.factor, b.global_bytes)


# -------------------------------------------------------------- recorder
def test_recorder_bytes_participants_and_local_flops():
    """On (4, 4): a local product (rank 0's 2·8·64·16 FLOPs, not the global
    one DTensor's propagation runs for shapes), an all-gather over
    'model', a reduce-scatter and an all-reduce of a partial sum."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    with dryrun.fake_world(16):
        mesh = init_device_mesh("cpu", (4, 4),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(8, 64), mesh,
                                   (Shard(0), Replicate()), run_check=False)
            w = DTensor.from_local(torch.empty(64, 16), mesh,
                                   (Replicate(), Shard(1)), run_check=False)
            p = DTensor.from_local(torch.empty(8, 64), mesh,
                                   (Replicate(), Partial()), run_check=False)
            rec = ha.CollectiveRecorder()
            with FlopCounterMode(display=False) as fc, rec:
                y = x @ w
                y.redistribute(mesh, (Shard(0), Replicate()))
                p.redistribute(mesh, (Replicate(), Shard(0)))
                p.redistribute(mesh, (Replicate(), Replicate()))
    assert fc.get_total_flops() == 2 * 8 * 64 * 16
    got = [(o.kind, o.bytes_per_device, o.participants, o.multiplier)
           for o in rec.ops]
    assert got == [("all-gather", 8 * 64 * 4, 4, 1.0),
                   ("reduce-scatter", 2 * 64 * 4, 4, 1.0),
                   ("all-reduce", 8 * 64 * 4, 4, 1.0)]
    assert ha.collective_summary(rec.ops)["total_bytes"] == (
        8 * 64 * 4 * 4 + 2 * 64 * 4 * 4 + 2 * 8 * 64 * 4 * 4)


def test_flops_of_the_unscanned_matmul_chain():
    """The reference's test_fwd_flops_vs_cost_analysis_unscanned, with
    FlopCounterMode in XLA's place: within 10 % of 2·B·S·D·F·2."""
    from torch.utils.flop_counter import FlopCounterMode
    D, F, B, S = 64, 256, 2, 32
    w1, w2, x = torch.ones(D, F), torch.ones(F, D), torch.ones(B, S, D)
    with FlopCounterMode(display=False) as fc:
        torch.sum(torch.einsum("bsf,fd->bsd",
                               torch.einsum("bsd,df->bsf", x, w1), w2))
    expect = 2 * B * S * D * F * 2
    assert abs(fc.get_total_flops() - expect) / expect < 0.1


# ---------------------------------------------------------- smoke traces
@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen2-0.5b", "train_4k", "single"),
    ("mamba2-370m", "train_4k", "single"),
    ("seamless-m4t-large-v2", "train_4k", "single"),
    ("qwen2-moe-a2.7b", "decode_32k", "multi"),
    ("zamba2-2.7b", "decode_32k", "multi")])
def test_smoke_trace_ok_and_equal_to_the_reference_cost_model(
        arch, shape, mesh, tmp_path):
    from repro.configs import LM_SHAPES, get_smoke_config
    from repro.launch import costmodel
    rec = dryrun.run_cell(arch, shape, mesh, str(tmp_path), device="cpu",
                          smoke=True)
    assert rec["status"] == "ok"
    assert REF_KEYS <= set(rec)
    assert REF_MEMORY_KEYS <= set(rec["memory"])
    assert REF_ROOFLINE_KEYS <= set(rec["roofline"])
    assert rec["chips"] == (512 if mesh == "multi" else 256)
    want = costmodel.step_costs(get_smoke_config(arch), LM_SHAPES[shape])
    assert (rec["model_flops"], rec["hlo_flops"], rec["hbm_bytes"],
            rec["tokens"]) == (want.model_flops, want.hlo_flops,
                               want.hbm_bytes, want.tokens)
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert mem["per_device_total_gb"] * 1e9 == pytest.approx(
        mem["argument_bytes"] + mem["temp_bytes"])
    assert rec["cost_analysis_flops"] > 0
    assert rec["collectives"]["count"] == sum(
        rec["collective_calls"].values()) > 0
    if shape.startswith("decode"):           # the in-place cache writes
        assert mem["alias_bytes"] > 0
    calls = json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json")
                       .read_text())
    assert sum(c["calls"] for c in calls) == rec["collectives"]["count"]


# -------------------------------------------------------------- fallback
@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_device_defaults_to_the_card_and_raises_without_one(tmp_path):
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        dryrun.run_cell("qwen2-0.5b", "train_4k", "single", smoke=True)
    out = tmp_path / "d.json"
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                        "--out", str(out)]) == 1
    rec = json.loads(out.read_text())["qwen2-0.5b|decode_32k|single"]
    assert rec["status"] == "error" and "CUDA" in rec["error"]


def test_a_process_group_already_open_is_refused():
    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="already initialised"):
            with dryrun.fake_world(4):
                pass


# ------------------------------------------ against the reference's GSPMD
# The reference's collective summary of one smoke cell, compiled by the
# unchanged JAX package with 512 host devices in a process of its own
# (XLA fixes the device count at its first use).
_REF_SMOKE = """
import json, sys
from repro.configs import LM_SHAPES, get_smoke_config
from repro.launch import hlo_analysis
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import build_step
from repro.parallel.sharding import Sharder
arch, shape, kind = sys.argv[1:4]
mesh = make_production_mesh(multi_pod=kind == "multi")
with mesh:
    fn, specs = build_step(get_smoke_config(arch), LM_SHAPES[shape],
                           Sharder(mesh=mesh))
    hlo = fn.lower(*specs).compile().as_text()
print(json.dumps(hlo_analysis.collective_summary(
    hlo_analysis.analyze_collectives(hlo, mesh.devices.size))))
"""


def _reference_collectives(arch, shape, mesh):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    out = subprocess.run([sys.executable, "-c", _REF_SMOKE, arch, shape,
                          mesh], env=env, capture_output=True, text=True,
                         check=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_smoke_decode_attends_the_cache_where_it_lies(tmp_path):
    """qwen3-32b smoke decode_32k on the (16, 16) mesh: the KV cache is
    split on its sequence ('model') and batch ('data').  No all-gather of
    the attention returns one rank's block of a layer's K or V or more,
    and the step moves at most 2× the reference's collective bytes."""
    from repro.configs import LM_SHAPES, get_smoke_config
    arch, shape = "qwen3-32b", "decode_32k"
    rec = dryrun.run_cell(arch, shape, "single", str(tmp_path),
                          device="cpu", smoke=True)
    cfg, sh = get_smoke_config(arch), LM_SHAPES[shape]
    block = ((sh.global_batch // 16) * (sh.seq_len // 16) * cfg.n_kv_heads
             * cfg.d_head * 2)
    calls = json.loads((tmp_path / f"{arch}__{shape}__single.json")
                       .read_text())
    gathers = [c for c in calls if c["kind"] == "all-gather"
               and c["computation"].startswith("models/layers.py")
               and c["bytes_per_device"] >= block]
    assert not gathers, gathers
    ref = _reference_collectives(arch, shape, "single")
    got = rec["collectives"]["total_bytes"]
    print(f"collective bytes: port {got:.0f}, reference "
          f"{ref['total_bytes']:.0f}")
    assert got <= 2 * ref["total_bytes"], (got, ref)


# A Mamba2 width whose projection (2·128 + 2·8 + 16 = 288 columns)
# splits 18 to a rank over a 16-wide 'model' axis, the offsets of its
# parts (128, 272) inside shards, and whose 16 heads split 1 to a rank:
# the full configs' case (zamba2-2.7b: 10,448 = 16 × 653, offsets 5,120
# and 10,368).
_STRADDLE = {"ssm_headdim": 8, "ssm_state": 8}


@pytest.mark.parametrize("arch,shape", [("zamba2-2.7b", "prefill_32k"),
                                        ("mamba2-370m", "train_4k"),
                                        ("zamba2-2.7b", "decode_32k")])
def test_mamba_projection_is_split_without_a_gather(arch, shape, tmp_path,
                                                    monkeypatch):
    """The parts of the input projection (z, x, B | C, dt) come out placed
    without gathering the projection: no all-gather is recorded in
    ``_split_proj`` or ``_split_xbc``, forward or backward, nor in the
    decode step, whose Δ accumulator keeps the projection's column split
    (its parts are handed out by one all-to-all)."""
    from repro_torch import configs
    from repro_torch.models.mamba2 import _dims
    smoke = configs.get_smoke_config
    monkeypatch.setattr(configs, "get_smoke_config", lambda a: (
        dataclasses.replace(smoke(a), **_STRADDLE)))
    cfg = configs.get_smoke_config(arch)
    d_in, H, _, _, _, conv_dim, proj = _dims(cfg)
    assert proj % 16 == 0 and d_in % (proj // 16) and H % 16 == 0
    rec = dryrun.run_cell(arch, shape, "single", str(tmp_path),
                          device="cpu", smoke=True)
    assert rec["status"] == "ok"
    calls = json.loads((tmp_path / f"{arch}__{shape}__single.json")
                       .read_text())
    split = [c for c in calls if c["kind"] == "all-gather" and (
        c["computation"].endswith(("mamba2.py:_split_proj",
                                   "mamba2.py:_split_xbc")))]
    assert not split, split
    peak = json.loads((tmp_path / f"{arch}__{shape}__single.peak.json")
                      .read_text())
    assert peak["peak_bytes"] == rec["memory"]["argument_bytes"] + rec[
        "memory"]["temp_bytes"]
    assert 0 < len(peak["largest"]) <= 10 and peak["computation"]
