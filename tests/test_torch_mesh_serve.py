"""Port conformance, the slot mesh through the serving entry points on the
CPU: the pipelined engine at two shards, depth 1 against depth 2 (the
reference's ``tests/test_engine.py::ENGINE_MESH_CHILD``), and ``serve
--devices 2 --device cpu`` in each KWS mode against ``--devices 1``.

Tolerances: every decision, fire, frame count and summary field equal
(the slot mesh changes no output bit, and neither does the depth)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.deltakws import CONFIG
from repro_torch.frontend.fex import FeatureExtractor
from repro_torch.launch import serve as tserve
from repro_torch.launch import streaming as tstream
from repro_torch.launch.engine import run_audio_requests
from repro_torch.launch.mesh import SlotMesh
from repro_torch.models import kws as tkws


def _no_slo(summary):
    return dataclasses.replace(summary, slo={})


def test_engine_two_shards_depth1_equals_depth2():
    """ENGINE_MESH_CHILD: 6 requests of 4000 samples over 4 slots on two
    shards, chunks of 1000: depth 2 decides as depth 1 does, with the same
    summary and frames, and admissions keep the shards within one stream
    of each other.  (In int8, whose plain FEx costs the CPU half the
    float one's time; the reference runs it in float.)"""
    fex = FeatureExtractor()
    params = tkws.init_kws(torch.Generator().manual_seed(0), CONFIG,
                           input_dim=fex.cfg.n_active)
    utt, chunk, requests = 4000, 1000, 6
    audio_q = np.random.default_rng(11).uniform(
        -0.5, 0.5, (requests, utt)).astype(np.float32)

    def run(depth):
        sess = tstream.StreamingKwsSession(
            params, CONFIG, threshold=0.1, batch=4, fex=fex,
            mesh=SlotMesh.on("cpu", 2), numerics="int8")
        assert sess.n_shards == 2
        sched = tstream.SlotScheduler(sess)
        for req in range(requests):
            sched.submit(req)
        done, stats = run_audio_requests(
            sess, sched, ctl=None, audio_q=audio_q, chunk=chunk,
            chunks_per_utt=-(-utt // chunk),
            real_frames=utt // fex.cfg.frame_shift, depth=depth,
            warm=False)
        return done, _no_slo(sess.summary()), stats

    d1, s1, st1 = run(1)
    d2, s2, st2 = run(2)
    assert d2 == d1 and len(d1) == requests
    assert s2 == s1 and s1.frames > 0
    assert st2["frames_served"] == st1["frames_served"] > 0
    assert st2["slo"]["shard_imbalance"]["max"] <= 1
    assert st1["slo"]["shard_imbalance"]["max"] <= 1


def _argv(mode, devices):
    base = ["--mode", mode, "--device", "cpu", "--slots", "2",
            "--devices", str(devices), "--train-steps", "0",
            "--numerics", "int8"]
    if mode == "kws-audio":
        return base + ["--requests", "2", "--chunk-samples", "1024"]
    extra = ["--stream-seconds", "0.5", "--chunk-samples", "2048",
             "--fire-threshold", "0.09", "--release-threshold", "0.085"]
    if mode == "kws-cascade":
        extra += ["--wake-threshold", "0.45", "--sleep-threshold", "0.4"]
    return base + extra


@pytest.mark.parametrize("mode", ["kws-audio", "kws-detect", "kws-cascade"])
def test_serve_two_devices_on_cpu_equals_one(mode):
    runs = {}
    for n in (1, 2):
        args = tserve.build_parser().parse_args(_argv(mode, n))
        tserve.validate_args(args)
        if mode == "kws-audio":
            sess, done, _, stats, _ = tserve.serve_kws_audio(args)
            runs[n] = (sess, done, stats["frames_served"])
        else:
            sess, point, stats, _, _ = tserve.serve_kws_detect(args)
            runs[n] = (sess, stats["fires"], stats["frames"], point)
    (one, *got1), (two, *got2) = runs[1], runs[2]
    assert one.n_shards == 1 and two.n_shards == 2
    assert two.mesh.devices.tolist() == [torch.device("cpu")] * 2
    assert got2 == got1
    assert _no_slo(two.summary()) == _no_slo(one.summary())
    assert tserve._on_devices(two).startswith("2 device(s) (cpu")
