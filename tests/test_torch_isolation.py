"""The port stands alone: repro_torch imports neither jax nor repro, its
entry points default to the GPU and raise without one, and its kernel
wrappers count launches only when they launch a CUDA kernel."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None                     # any `import jax` now fails
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(k for k, v in sys.modules.items() if v is not None
             and (k == "repro" or k.startswith(("repro.", "jax"))))
assert not bad, bad
print(len(mods))
"""


def test_every_module_imports_with_jax_blocked():
    src = str(PKG.parent)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 30      # the whole package


_IMPORT_CASCADE = """
import sys
sys.modules["jax"] = None                     # any `import jax` now fails
from repro_torch.kernels import compaction, wake_head
from repro_torch.launch import streaming
from repro_torch.core import delta_gru, fixed_point
for name in ("CascadeConfig", "CascadeState", "init_cascade_state",
             "cascade_wake_scan", "cascade_wake_scan_loop",
             "_process_audio_chunk_cascade",
             "_process_audio_chunk_cascade_int"):
    assert hasattr(streaming, name), name
assert delta_gru.masked_delta_gru_scan and fixed_point.masked_int_gru_scan
assert compaction.event_driven_seq and compaction.held_slots
assert wake_head.wake_head and wake_head.wake_head_ref
bad = sorted(k for k, v in sys.modules.items() if v is not None
             and (k == "repro" or k.startswith(("repro.", "jax"))))
assert not bad, bad
print("ok")
"""


def test_cascade_modules_import_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _IMPORT_CASCADE],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(PKG.parent)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "ok"


_IMPORT_FAULTS = """
import sys
sys.modules["jax"] = None                     # any `import jax` now fails
from repro_torch.launch import engine, faults, serve, streaming
for mod, names in ((faults, ("FaultSpec", "FaultPlan", "FaultInjector",
                             "adversarial_plan", "parse_fault_specs")),
                   (streaming, ("SupervisorConfig", "QUARANTINE_DEFAULT",
                                "_upload")),
                   (serve, ("OverloadPolicy", "AdmissionController",
                            "_parse_ladder", "_session_extras")),
                   (engine, ("PipelinedEngine", "FetchedStep",
                             "run_audio_requests", "run_continuous_detect"))):
    for name in names:
        assert hasattr(mod, name), (mod.__name__, name)
bad = sorted(k for k, v in sys.modules.items() if v is not None
             and (k == "repro" or k.startswith(("repro.", "jax"))))
assert not bad, bad
print("ok")
"""


def test_fault_and_engine_modules_import_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _IMPORT_FAULTS],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(PKG.parent)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "ok"


_IMPORT_TRAIN = """
import sys
sys.modules["jax"] = None                     # any `import jax` now fails
from repro_torch.core import delta_gru, quantize
from repro_torch.data import gscd
from repro_torch.kernels import platform, xla_math
from repro_torch.launch import serve, train
from repro_torch.models import kws
from repro_torch.train import checkpoint, mining, optimizer, promote, trainer
for mod, names in ((optimizer, ("AdamWConfig", "AdamWState", "init",
                                "lr_at", "global_norm", "update")),
                   (checkpoint, ("save", "latest_step", "restore", "meta")),
                   (trainer, ("Trainer", "TrainerConfig", "StepStats")),
                   (promote, ("make_kws_step_fn", "eval_promotion",
                              "promote_checkpoint")),
                   (mining, ("MiningConfig", "mine_hard_negatives")),
                   (kws, ("loss_fn", "frame_loss_fn", "forward_frames",
                          "accuracy_11class", "params_to_numpy")),
                   (quantize, ("ste_quantize", "quantize_weights_8b")),
                   (delta_gru, ("temporal_sparsity",)),
                   (gscd, ("load_wav_8k", "load_dataset",
                           "load_utterance_bank", "synth_epoch")),
                   (platform, ("refuse_grad",)), (train, ("train_kws",)),
                   (serve, ("quick_train",))):
    for name in names:
        assert hasattr(mod, name), (mod.__name__, name)
bad = sorted(k for k, v in sys.modules.items() if v is not None
             and (k == "repro" or k.startswith(("repro.", "jax"))))
assert not bad, bad
print("ok")
"""


def test_training_modules_import_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _IMPORT_TRAIN],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(PKG.parent)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "ok"


_IMPORT_TUNING = """
import sys
sys.modules["jax"] = None                     # any `import jax` now fails
from repro_torch import commands
from repro_torch.core import sparsity
from repro_torch.kernels import autotune, ref
for mod, names in ((autotune, ("SCHEMA_VERSION", "ENV_CACHE", "ENV_ENABLE",
                               "legal_block_b", "validate_block_b",
                               "validate_divisor", "cache_path",
                               "autotune_enabled", "clear_memo",
                               "threshold_bucket", "platform_tag",
                               "cache_key", "lookup", "record", "resolve",
                               "tune_delta_gru_seq",
                               "tune_batched_iir_fex")),
                   (sparsity, ("SparsityAccumulator", "delta_histogram",
                               "sparsity_at_threshold")),
                   (ref, ("delta_matvec_ref", "iir_fex_ref",
                          "delta_gru_cell_ref")),
                   (commands, ("ALL_COMMANDS",))):
    for name in names:
        assert hasattr(mod, name), (mod.__name__, name)
import importlib.util, pathlib
for name in ("torch_quickstart", "torch_serve_streaming_kws",
             "torch_train_kws_e2e", "torch_lm_train"):
    spec = importlib.util.spec_from_file_location(
        name, pathlib.Path({examples!r}) / f"{{name}}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k, v in sys.modules.items() if v is not None
             and (k == "repro" or k.startswith(("repro.", "jax",
                                                "benchmarks"))))
assert not bad, bad
print("ok")
"""


def test_tuning_modules_and_examples_import_with_jax_blocked():
    examples = PKG.parent.parent / "examples"
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_TUNING.format(examples=str(examples))],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(PKG.parent)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "ok"


_IMPORT_LM = """
import pkgutil, sys
sys.modules["jax"] = None                     # any `import jax` now fails
import repro_torch
mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")}
need = {"repro_torch.parallel", "repro_torch.parallel.sharding",
        "repro_torch.launch.costmodel", "repro_torch.launch.inputs",
        "repro_torch.launch.steps", "repro_torch.data.lm_data",
        "repro_torch.core.delta_dense"} | {
        f"repro_torch.models.{m}" for m in ("layers", "moe", "transformer",
                                            "mamba2", "hybrid", "encdec",
                                            "registry")}
assert need <= mods, sorted(need - mods)
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import get_api, params_from_numpy
from repro_torch.parallel.sharding import (AxTree, Sharder, DEFAULT_RULES,
                                           DECODE_RULES, slot_shards,
                                           check_slot_partition)
from repro_torch.train.optimizer import opt_axes
from repro_torch.parallel.sharding import (NamedSharding, place,
                                           spec_placements, local_bounds)
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     run_ranks)
from repro_torch.models.layers import local_blocks, gather_fsdp, tp_down_proj
from repro_torch.launch.inputs import place_batch
for arch in ARCH_IDS:
    get_api(get_config(arch)).init(None)      # meta tensors: no allocation
    get_smoke_config(arch)
bad = sorted(k for k, v in sys.modules.items() if v is not None
             and (k == "repro" or k.startswith(("repro.", "jax"))))
assert not bad, bad
print("ok")
"""


def test_lm_modules_import_with_jax_blocked():
    """The package walk covers ``repro_torch.parallel`` and every LM
    module; the full-width configs build as meta tensors."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_LM],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(PKG.parent)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "ok"


_IMPORT_DRYRUN = """
import pkgutil, sys
sys.modules["jax"] = None                     # any `import jax` now fails
import repro_torch
mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")}
need = {"repro_torch.launch.dryrun", "repro_torch.launch.hlo_analysis"}
assert need <= mods, sorted(need - mods)
from repro_torch.launch.dryrun import (build_parser, fake_inputs, main,
                                       run_cell, trace_step)
from repro_torch.launch.hlo_analysis import (CollectiveOp,
                                             CollectiveRecorder,
                                             collective_summary, grouped,
                                             shape_bytes)
bad = sorted(k for k, v in sys.modules.items() if v is not None
             and (k == "repro" or k.startswith(("repro.", "jax"))))
assert not bad, bad
print("ok")
"""


def test_dryrun_modules_import_with_jax_blocked():
    """The dry-run and its collective inventory import neither jax nor
    repro."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_DRYRUN],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(PKG.parent)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "ok"


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_serve_streaming_kws.py",
                                  "torch_train_kws_e2e.py",
                                  "torch_lm_train.py", "chip_smoke.py"])
def test_examples_and_chip_smoke_import_nothing_of_jax(name):
    root = PKG.parent.parent
    path = root / "examples" / name if name.startswith("torch_") \
        else root / name
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "benchmarks"), mod


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.configs.deltakws import SMOKE_CONFIG
    from repro_torch.launch import serve
    from repro_torch.launch.streaming import StreamingKwsSession
    from repro_torch.models import kws
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = kws.init_kws(torch.Generator().manual_seed(0), SMOKE_CONFIG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingKwsSession(params, SMOKE_CONFIG)
    assert serve.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        serve.serve_kws_audio(serve.build_parser().parse_args([]))
    args = serve.build_parser().parse_args(["--mode", "kws-detect"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        serve.serve_kws_detect(args)
    args = serve.build_parser().parse_args(["--mode", "kws-cascade"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        serve.serve_kws_detect(args)
    from repro_torch.launch import train
    assert train.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--steps", "1", "--ckpt-dir", "unused"])


def test_cpu_wrappers_run_plain_versions_without_counting():
    from repro_torch.kernels import delta_gru_seq as dgs
    from repro_torch.kernels import iir_fex
    iir_fex.batched_iir_fex.launches = 0
    dgs.delta_gru_seq.launches = 0
    coef = torch.rand(6, 3)
    feats, _ = iir_fex.batched_iir_fex(torch.rand(2, 256), coef,
                                       iir_fex.init_fex_kernel_state(2, 3))
    ref, _ = iir_fex.batched_iir_fex_ref(torch.rand(2, 256) * 0, coef,
                                         iir_fex.init_fex_kernel_state(2, 3))
    assert feats.shape == ref.shape == (2, 2, 3)
    I, H, B = 4, 8, 2
    z = torch.zeros
    hs, *_ = dgs.delta_gru_seq(torch.rand(3, B, I), z(B, H), z(B, I),
                               z(B, H), z(B, 3 * H), z(B, 3 * H),
                               torch.rand(I, 3 * H), torch.rand(H, 3 * H),
                               0.1)
    assert hs.shape == (3, B, H) and np.isfinite(hs.numpy()).all()
    dgs.delta_gru_seq.masked_launches = 0
    dgs.delta_gru_seq_int.masked_launches = 0
    awake = torch.tensor([[True, False]] * 3)
    hs, *_ = dgs.delta_gru_seq(torch.rand(3, B, I), z(B, H), z(B, I),
                               z(B, H), z(B, 3 * H), z(B, 3 * H),
                               torch.rand(I, 3 * H), torch.rand(H, 3 * H),
                               0.1, awake=awake)
    assert hs.shape == (3, B, H) and not hs[:, 1].any()
    from repro_torch.core import fixed_point as fp
    iir_fex.batched_iir_fex_int.launches = 0
    dgs.delta_gru_seq_int.launches = 0
    codes, _ = iir_fex.batched_iir_fex_int(
        torch.randint(-2048, 2048, (2, 256), dtype=torch.int16),
        torch.randint(-64, 64, (6, 3), dtype=torch.int32),
        fp.init_int_fex_state(2, 3), fmt=fp.FexFormats())
    assert codes.shape == (2, 2, 3) and codes.dtype == torch.int16
    w = fp.IntGruWeights(torch.ones((I, 3 * H), dtype=torch.int8),
                         torch.ones((H, 3 * H), dtype=torch.int8),
                         torch.zeros(3 * H, dtype=torch.int32))
    st = fp.init_int_delta_state(B, I, H, w)
    hs, *_ = dgs.delta_gru_seq_int(
        torch.randint(-2048, 2048, (3, B, I), dtype=torch.int16), *st,
        w.w_x, w.w_h, (0, 0), fmt=fp.GruFormats())
    assert hs.shape == (3, B, H) and hs.dtype == torch.int16
    hs, *_ = dgs.delta_gru_seq_int(
        torch.randint(-2048, 2048, (3, B, I), dtype=torch.int16), *st,
        w.w_x, w.w_h, (0, 0), fmt=fp.GruFormats(), awake=awake)
    assert hs.shape == (3, B, H) and not hs[:, 1].any()
    from repro_torch.kernels import ops
    ops.delta_matvec.launches = ops.delta_gru_cell.launches = 0
    out, mask = ops.delta_matvec_auto(torch.rand(B, 8), torch.rand(8, 6),
                                      z(B, 6), block_i=4, block_o=3)
    assert out.shape == (B, 6) and mask.tolist() == [1, 1]
    h1, *_ = ops.delta_gru_cell(torch.rand(B, I), z(B, H), z(B, I), z(B, H),
                                z(B, 3 * H), z(B, 3 * H),
                                torch.rand(I, 3 * H), torch.rand(H, 3 * H),
                                0.1)
    assert h1.shape == (B, H) and np.isfinite(h1.numpy()).all()
    from repro_torch.models import detector as det
    ops.detect_head.launches = 0
    st, ev = ops.detect_head(torch.rand(3, B, 12), det.init_detector_state(
        B, 12), det.DetectorConfig(fire_threshold=0.05))
    assert ev.shape == (3, B) and st.smooth.shape == (B, 12)
    from repro_torch.launch.streaming import CascadeConfig
    ops.wake_head.launches = 0
    tr, aw, hg = ops.wake_head(torch.rand(3, B, 2),
                               torch.zeros(B, dtype=torch.bool),
                               torch.zeros(B, dtype=torch.int32),
                               CascadeConfig())
    assert tr.shape == (3, B) and aw.shape == hg.shape == (B,)
    for wrapper in (iir_fex.batched_iir_fex, dgs.delta_gru_seq,
                    iir_fex.batched_iir_fex_int, dgs.delta_gru_seq_int,
                    ops.delta_matvec, ops.delta_gru_cell, ops.detect_head,
                    ops.wake_head):
        assert wrapper.launches == 0
    assert dgs.delta_gru_seq.masked_launches == 0
    assert dgs.delta_gru_seq_int.masked_launches == 0
