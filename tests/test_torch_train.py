"""Port conformance, training: repro_torch's optimizer, checkpoints,
trainer, training step, promotion, mining, loaders and the training entry
points against the JAX package's, on the CPU.

Tolerances: AdamW's parameters and moments within 1e-6 relative to their
size over 5 steps (the float32 updates differ from XLA's where XLA fuses a
product into an add, by an ulp per step); three training steps of the
KWS model at Δ_TH 0 within 1e-5 absolute (measured: 1.5e-6 float, 6e-8
QAT — the gradients differ by ~1e-7 of their size, and Adam's m/√v
magnifies that where a gradient is near 0; a step of lr 3e-3 taken the
wrong way would show as 6e-3); checkpoints, bundles and int8 decisions bit for
bit; mining scores within 1e-6 with the same order.
"""
import functools
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.deltakws import SMOKE_CONFIG as J_SMOKE
from repro.data import gscd as jgscd
from repro.frontend.fex import FeatureExtractor as JFex
from repro.launch import streaming as jstream
from repro.models import kws as jkws
from repro.train import checkpoint as jckpt
from repro.train import mining as jmining
from repro.train import optimizer as jopt
from repro.train import promote as jpromote
from repro_torch.configs.deltakws import SMOKE_CONFIG as T_SMOKE
from repro_torch.data import gscd as tgscd
from repro_torch.frontend.fex import FeatureExtractor as TFex
from repro_torch.launch import serve as tserve
from repro_torch.launch import streaming as tstream
from repro_torch.launch import train as ttrain
from repro_torch.models import kws as tkws
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import mining as tmining
from repro_torch.train import optimizer as topt
from repro_torch.train import promote as tpromote
from repro_torch.train.trainer import Trainer, TrainerConfig

I, B, F = 10, 4, 16


@functools.lru_cache(maxsize=None)
def _weights():
    jp, _ = jkws.init_kws(jax.random.PRNGKey(0), J_SMOKE, input_dim=I)
    return {k: np.asarray(v) for k, v in jp.items()}


def _batch(step):
    rng = np.random.default_rng(100 + step)
    feats = np.round(np.cumsum(0.2 * rng.standard_normal((B, F, I)), 1)
                     * 2048) / 2048
    return feats.astype(np.float32), rng.integers(0, 12, B).astype(np.int32)


def _tensors(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


# ---------------------------------------------------------------- AdamW
@pytest.mark.parametrize("grad_clip", [1e-3, 1e3], ids=["clipped",
                                                         "unclipped"])
def test_adamw_matches_jax_over_5_steps(grad_clip):
    cfg = dict(lr=0.05, weight_decay=0.1, grad_clip=grad_clip,
               warmup_steps=2, total_steps=6)
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    jp, tp = ({k: jnp.asarray(v) for k, v in params.items()},
              _tensors(params))
    js, ts = jopt.init(jp), topt.init(tp)
    jc, tc = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    for g in grads:
        jp, js, jm = jopt.update(jc, {k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp)
        tp, ts, tm = topt.update(tc, _tensors(g), ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(ts.step) == int(js.step) == 5
    assert ts.step.dtype == torch.int32
    clipped = float(jm["grad_norm"]) > grad_clip
    assert clipped == (grad_clip < 1)
    for k in params:
        for got, want in ((tp[k], jp[k]), (ts.master[k], js.master[k]),
                          (ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6 * np.abs(
                                           np.asarray(want)).max())
        assert tp[k].data_ptr() != ts.master[k].data_ptr()   # no alias


def test_lr_schedule_matches_jax():
    c = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = [float(topt.lr_at(topt.AdamWConfig(**c), torch.tensor(s)))
           for s in range(0, 101, 5)]
    want = [float(jopt.lr_at(jopt.AdamWConfig(**c), jnp.asarray(s)))
            for s in range(0, 101, 5)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[0] == 0.0 and abs(got[2] - 1.0) < 1e-6


# ------------------------------------------------------------- checkpoints
def _opt_tree(pkg):
    w = _weights()
    if pkg == "jax":
        p = {k: jnp.asarray(v) for k, v in w.items()}
        s = jopt.init(p)
        return {"params": p, "opt": s._replace(
            step=jnp.asarray(7, jnp.int32),
            m=jax.tree.map(lambda a: a + 0.5, s.m))}
    p = _tensors(w)
    s = topt.init(p)
    return {"params": p, "opt": s._replace(
        step=torch.tensor(7, dtype=torch.int32),
        m={k: v + 0.5 for k, v in s.m.items()})}


def _assert_trees_equal(a, b):
    fa, fb = tckpt._flatten(a), tckpt._flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = (np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
                for v in (fa[k], fb[k]))
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_checkpoint_roundtrip_and_torn_writes(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16)},
            "t": (torch.zeros(2), torch.ones(3, dtype=torch.int32))}
    tckpt.save(tmp_path, 7, tree, extra={"note": "x"})
    assert tckpt.latest_step(tmp_path) == 7
    back = tckpt.restore(tmp_path, 7, tree)
    assert back["nested"]["b"].dtype == torch.bfloat16
    assert isinstance(back["t"], tuple)
    for a, b in zip(tckpt.leaves(tree), tckpt.leaves(back)):
        assert torch.equal(a, b)
    m = tckpt.meta(tmp_path, 7)
    assert m["dtypes"]["nested/b"] == "bfloat16" and m["extra"]["note"] == "x"
    # A crashed writer: a stale .tmp dir and a final dir without meta.json.
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_00000011").mkdir()
    assert tckpt.latest_step(tmp_path) == 7
    assert tckpt.latest_step(tmp_path / "missing") is None


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """Params and AdamW state written by one package restore in the other
    bit for bit, under the same flattened keys."""
    reader = "torch" if writer == "jax" else "jax"
    src, like = _opt_tree(writer), _opt_tree(reader)
    (jckpt if writer == "jax" else tckpt).save(tmp_path, 3, src)
    got = (jckpt if reader == "jax" else tckpt).restore(tmp_path, 3, like)
    assert sorted(jckpt.meta(tmp_path, 3)["keys"]) == sorted(
        tckpt._flatten(_opt_tree("torch")))
    if reader == "torch":
        assert isinstance(got["opt"], topt.AdamWState)
        _assert_trees_equal(got, _opt_tree("torch"))
    else:
        assert isinstance(got["opt"], jopt.AdamWState)
        flat = {k: np.asarray(v) for k, v in jckpt._flatten(got).items()}
        for k, v in tckpt._flatten(src).items():
            v = v.numpy()
            assert flat[k].dtype == v.dtype, k
            np.testing.assert_array_equal(flat[k], v, err_msg=k)
    # The promotion fold reads either package's checkpoint.
    b = tpromote.promote_checkpoint(tmp_path, T_SMOKE, 0.1)
    want_b = tpromote.promote(tkws.params_from_numpy(_weights()), 0.1)
    assert torch.equal(b.gru.w_h, want_b.gru.w_h) and b.gfmt == want_b.gfmt


def test_params_to_numpy_roundtrip():
    w = _weights()
    back = tkws.params_to_numpy(tkws.params_from_numpy(w))
    for k in tkws.PARAM_KEYS:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], w[k])


# ----------------------------------------------------------------- trainer
def _quadratic_trainer(ckpt_dir):
    cfg = topt.AdamWConfig(lr=0.05, weight_decay=0.0)
    params = {"w": torch.zeros(2)}

    def step_fn(p, s, batch):
        q = p["w"].detach().requires_grad_(True)
        loss = ((q - batch) ** 2).sum()
        g, = torch.autograd.grad(loss, [q])
        p2, s2, _ = topt.update(cfg, {"w": g}, s, p)
        return p2, s2, {"loss": loss.detach()}

    data = lambda step: torch.tensor([1.0, -1.0]) * (1 + 0.01 * step)
    return Trainer(TrainerConfig(ckpt_dir=str(ckpt_dir), ckpt_every=5,
                                 max_retries=3), step_fn, params,
                   topt.init(params), data)


def test_trainer_fault_recovery(tmp_path):
    """A step that raises is retried from the last checkpoint; the final
    state equals an uninterrupted run's, bit for bit (replayable data)."""
    ref = _quadratic_trainer(tmp_path / "ref")
    ref.run(20)
    armed = [True]

    def fault_hook(step):
        if step == 12 and armed[0]:
            armed[0] = False
            raise RuntimeError("injected node failure")

    ft = _quadratic_trainer(tmp_path / "ft")
    ft.run(20, fault_hook=fault_hook)
    assert ft.recoveries == 1 and ft.step == ref.step == 20
    assert torch.equal(ft.params["w"], ref.params["w"])
    assert [h.step for h in ft.history][-8:] == list(range(13, 21))
    # A fresh trainer restores the newest checkpoint and resumes there.
    again = _quadratic_trainer(tmp_path / "ft")
    assert again.maybe_restore() == 20
    assert torch.equal(again.params["w"], ref.params["w"])
    assert int(again.opt_state.step) == 20
    # reshard: the newest checkpoint re-placed onto a (1, 1) DeviceMesh
    # (a fake process group of one rank).
    import _torch_lm_mesh as H
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.sharding import Sharder
    with H.fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
        sh = Sharder(mesh=mesh).sharding((2,), ("mlp",))
        assert again.reshard({"params": {"w": sh}}) == 20
        assert again.params["w"].device_mesh is mesh
        assert torch.equal(again.params["w"].to_local(), ref.params["w"])
        assert int(again.opt_state.step) == 20


def test_trainer_gives_up_after_max_retries(tmp_path):
    tr = _quadratic_trainer(tmp_path)

    def always(step):
        raise RuntimeError("dead device")
    with pytest.raises(RuntimeError, match="dead device"):
        tr.run(3, fault_hook=always)
    assert tr.recoveries == 4


def test_trainer_straggler_detection(tmp_path):
    import time
    params = {"w": torch.zeros(1)}

    def step_fn(p, s, batch):
        if batch == 7:
            time.sleep(0.25)
        return p, s, {"loss": torch.zeros(())}

    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                               straggler_factor=3.0),
                 step_fn, params, topt.init(params), lambda s: s)
    tr.run(12)
    assert 7 in tr.straggler_steps and len(tr.history) == 12


# -------------------------------------------------------- the training step
@pytest.mark.parametrize("qat", [False, True], ids=["float", "qat"])
def test_three_steps_match_jax(qat):
    """make_kws_step_fn in both packages from the same init on the same
    batches (Δ_TH 0): params, moments and metrics within tolerance."""
    ocfg = dict(lr=3e-3, weight_decay=0.01, warmup_steps=1, total_steps=3)
    jstep = jpromote.make_kws_step_fn(J_SMOKE, jopt.AdamWConfig(**ocfg),
                                      0.0, qat=qat)
    tstep = tpromote.make_kws_step_fn(T_SMOKE, topt.AdamWConfig(**ocfg),
                                      0.0, qat=qat)
    jp = {k: jnp.asarray(v) for k, v in _weights().items()}
    tp = _tensors(_weights())
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        feats, labels = _batch(step)
        jp, js, jm = jstep(jp, js, {"feats": jnp.asarray(feats),
                                    "labels": jnp.asarray(labels)})
        tp, ts, tm = tstep(tp, ts, {"feats": torch.tensor(feats),
                                    "labels": torch.tensor(labels)})
        for k in ("loss", "acc", "sparsity", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=2e-6, err_msg=k)
    diff = max(float(np.abs(tp[k].numpy() - np.asarray(jp[k])).max())
               for k in tkws.PARAM_KEYS)
    print(f"max |Δparam| after 3 steps: {diff:.2e}")        # pytest -s
    for k in tkws.PARAM_KEYS:
        assert not tp[k].requires_grad
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
        assert not np.array_equal(tp[k].numpy(), _weights()[k])   # trained


def test_port_trained_bundle_serves_alike_in_both_packages(tmp_path):
    """A bundle promoted from port-trained weights, saved by the port,
    loaded by each package and served by each int8 session on the same
    audio: every vote, transmit count and logit code equal."""
    tstep = tpromote.make_kws_step_fn(
        T_SMOKE, topt.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3),
        0.1, qat=True)
    tp = _tensors(_weights())
    ts = topt.init(tp)
    for step in range(3):
        feats, labels = _batch(step)
        tp, ts, _ = tstep(tp, ts, {"feats": torch.tensor(feats),
                                   "labels": torch.tensor(labels)})
    path = tpromote.save_bundle(tmp_path / "trained",
                                tpromote.promote(tp, 0.1, fex=TFex()))
    jb, tb = jpromote.load_bundle(path), tpromote.load_bundle(path)
    audio, _ = jgscd.synth_batch(np.random.default_rng(5), 2)
    audio = audio[:, 2000:3024]
    js = jstream.StreamingKwsSession(None, J_SMOKE, batch=2, fex=JFex(),
                                     backend="xla", fex_backend="xla",
                                     numerics="int8", bundle=jb)
    ts_ = tstream.StreamingKwsSession(None, T_SMOKE, batch=2, fex=TFex(),
                                      device="cpu", numerics="int8",
                                      bundle=tb)
    want, got = js.process_audio(audio), ts_.process_audio(audio)
    for f in ("votes", "nz", "logits"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


# ------------------------------------------------------------------ mining
def test_mining_scores_and_order_match_jax():
    cfg = dict(n_candidates=5, top_k=3, duration_s=0.25)
    w = _weights()
    jf = JFex()
    want = jmining.mine_hard_negatives(
        {k: jnp.asarray(v) for k, v in w.items()}, J_SMOKE,
        lambda a: jf(a, backend="xla"), np.random.default_rng(9),
        jmining.MiningConfig(**cfg), threshold=0.1)
    got = tmining.mine_hard_negatives(
        tkws.params_from_numpy(w), T_SMOKE, TFex(),
        np.random.default_rng(9), tmining.MiningConfig(**cfg),
        threshold=0.1)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))   # order
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    assert got[2][0] >= got[2][-1]
    with pytest.raises(ValueError, match="top_k"):
        tmining.mine_hard_negatives(tkws.params_from_numpy(w), T_SMOKE,
                                    TFex(), np.random.default_rng(0),
                                    tmining.MiningConfig(top_k=9,
                                                         n_candidates=2))


# ----------------------------------------------------------------- loaders
def _write_wav(path, samples, rate=16000, width=2):
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(np.asarray(samples).astype(
            np.int16 if width == 2 else np.uint8).tobytes())


def test_wav_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    for name in ("yes", "no", "unknown"):
        for i in range(2):
            x = np.zeros(12000)
            x[3000 + 500 * i:6000] = 9000 * np.sin(np.arange(
                3000 - 500 * i) / (3 + i))
            _write_wav(tmp_path / name / f"{i}.wav",
                       x + rng.integers(-30, 30, x.shape))
    _write_wav(tmp_path / "go" / "a.wav", rng.integers(-9000, 9000, 4000),
               rate=8000)
    one = tmp_path / "yes" / "0.wav"
    np.testing.assert_array_equal(tgscd.load_wav_8k(one),
                                  jgscd.load_wav_8k(one))
    assert tgscd.load_wav_8k(one).shape == (8000,)
    got, want = (m.load_dataset(str(tmp_path), n_per_class=1)
                 for m in (tgscd, jgscd))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    tb, jb = (m.load_utterance_bank(tmp_path) for m in (tgscd, jgscd))
    assert sorted(tb) == sorted(jb) and len(tb) >= 3
    for c in tb:
        for g, w in zip(tb[c], jb[c]):
            np.testing.assert_array_equal(g, w)
            assert len(g) < 8000                      # trimmed
    for g, w in zip(tgscd.synth_epoch(3, 4), jgscd.synth_epoch(3, 4)):
        np.testing.assert_array_equal(g, w)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "x.wav").write_bytes(b"RIFF garbage")
    _write_wav(bad / "w8.wav", [1, 2, 3], width=1)
    _write_wav(bad / "r.wav", [1, 2, 3], rate=11025)
    for f, msg in (("x.wav", "corrupt"), ("w8.wav", "16-bit"),
                   ("r.wav", "multiple")):
        with pytest.raises(ValueError, match=msg):
            tgscd.load_wav_8k(bad / f)
    with pytest.raises(ValueError, match="no <label>"):
        tgscd.load_dataset(str(bad))
    with pytest.raises(ValueError, match="no keyword"):
        tgscd.load_utterance_bank(bad)


# ------------------------------------------------------------- entry points
def test_launch_train_on_cpu(tmp_path, capsys, monkeypatch):
    """Tiny on the CPU: the plain FEx costs ~0.5 ms per sample step."""
    monkeypatch.setattr(ttrain, "EVAL_N", 2)
    bundle = tmp_path / "b.npz"
    rc = ttrain.main(["--arch", "deltakws", "--device", "cpu", "--steps",
                      "2", "--batch", "2", "--ckpt-dir",
                      str(tmp_path / "ck"), "--promote", str(bundle)])
    out = capsys.readouterr().out
    assert rc == 0 and "loss" in out and "promoted int8" in out
    assert tckpt.latest_step(tmp_path / "ck") == 2
    jb = jpromote.load_bundle(bundle)                # the JAX package reads it
    assert jb.coef is not None and jb.threshold == 0.1
    with pytest.raises(SystemExit):                 # not an arch of the port
        ttrain.main(["--arch", "qwen2-0.6b"])


@pytest.mark.parametrize("mode,numerics", [
    ("kws-audio", "float32"), ("kws-detect", "int8"),
    ("kws-cascade", "float32")])
def test_serve_train_steps_on_cpu(mode, numerics, capsys, monkeypatch):
    """``serve --train-steps 2`` trains before serving (QAT for int8; the
    cascade's stage 0 too) and serves the trained weights; batches of 2
    (frame-level: 0.25 s streams) keep the CPU's plain FEx short."""
    monkeypatch.setattr(tserve, "TRAIN_BATCH", {False: 2, True: 2})
    monkeypatch.setattr(tserve, "TRAIN_SECONDS", 0.25)
    argv = ["--mode", mode, "--device", "cpu", "--numerics", numerics,
            "--slots", "2", "--train-steps", "2", "--requests", "1",
            "--stream-seconds", "0.25", "--chunk-samples", "2048"]
    assert tserve.main(argv) == 0
    out = capsys.readouterr().out
    assert "training detector for 2 steps" in out
    assert ("QAT" in out) == (numerics == "int8")
    assert ("stage-0 wake model" in out) == (mode == "kws-cascade")


def test_serve_train_steps_validation():
    ap = tserve.build_parser()
    assert ap.parse_args([]).train_steps == 120      # the reference's
    with pytest.raises(ValueError, match="train-steps"):
        tserve.validate_args(ap.parse_args(["--train-steps", "-1"]))
