"""Canonical command lines of the PyTorch/CUDA port — its single source
of truth (the counterpart of ``repro/commands.py``).

README.md's port section shows these commands, the port's examples print
them, and ``tests/test_torch_docs.py`` asserts that every string below
appears VERBATIM in a README code block, that the files and modules it
names exist and import, and that the serve and train lines parse against
the port's own CLIs.  Change a command here and the test walks you
through every surface that shows it.
"""
from __future__ import annotations

# Verify --------------------------------------------------------------------
TORCH_TESTS_CMD = "PYTHONPATH=src python -m pytest -q tests/test_torch_*.py"
CHIP_SMOKE_CMD = "python3 chip_smoke.py"

# Examples ------------------------------------------------------------------
QUICKSTART_CMD = "PYTHONPATH=src python examples/torch_quickstart.py"
STREAM_EXAMPLE_CMD = ("PYTHONPATH=src python "
                      "examples/torch_serve_streaming_kws.py")
TRAIN_EXAMPLE_CMD = "PYTHONPATH=src python examples/torch_train_kws_e2e.py"

# Serving (every mode trains --train-steps 120 first, as the reference) ----
SERVE_CMD = ("PYTHONPATH=src python -m repro_torch.launch.serve "
             "--mode kws-audio --slots 32 --requests 64")
SERVE_INT8_CMD = ("PYTHONPATH=src python -m repro_torch.launch.serve "
                  "--mode kws-audio --slots 32 --requests 64 "
                  "--numerics int8")
SERVE_SYNC_CMD = ("PYTHONPATH=src python -m repro_torch.launch.serve "
                  "--mode kws-audio --slots 32 --requests 64 --sync-loop")
SERVE_DETECT_CMD = ("PYTHONPATH=src python -m repro_torch.launch.serve "
                    "--mode kws-detect --slots 32 --stream-seconds 30")
SERVE_CASCADE_CMD = ("PYTHONPATH=src python -m repro_torch.launch.serve "
                     "--mode kws-cascade --slots 32 --stream-seconds 30")
SERVE_MESH_CMD = ("PYTHONPATH=src python -m repro_torch.launch.serve "
                  "--mode kws-audio --slots 32 --requests 64 --devices 2")
SERVE_FAULTS_CMD = (
    "PYTHONPATH=src python -m repro_torch.launch.serve "
    "--mode kws-audio --slots 32 --requests 64 "
    '--faults "nan_burst:0.05,dup_chunk:0.05,one_sample_chunk:0.05,'
    'churn_storm:0.05" --degrade-thresholds 0.2,0.4 --max-queue 48')

# LM stacks -----------------------------------------------------------------
LM_TESTS_CMD = "PYTHONPATH=src python -m pytest -q tests/test_torch_lm_*.py"
SERVE_LM_CMD = ("PYTHONPATH=src python -m repro_torch.launch.serve "
                "--mode lm --arch qwen2-0.5b --requests 8 --slots 4")
TRAIN_LM_CMD = ("PYTHONPATH=src python -m repro_torch.launch.train "
                "--arch qwen2-0.5b --full-config --steps 4 --batch 8 "
                "--seq 128")
LM_TRAIN_EXAMPLE_CMD = ("PYTHONPATH=src python examples/torch_lm_train.py "
                        "--arch qwen2-0.5b --steps 60")

# LM dry-run: every (arch × shape) cell's sharded step on the 256- and
# 512-rank production meshes, traced on fake tensors (the card by default).
DRYRUN_CMD = ("PYTHONPATH=src python -m repro_torch.launch.dryrun "
              "--all --mesh both --jobs 7")
DRYRUN_CPU_CMD = ("PYTHONPATH=src python -m repro_torch.launch.dryrun "
                  "--all --mesh both --device cpu --jobs 6")

# Train → deploy ------------------------------------------------------------
TRAIN_PROMOTE_CMD = ("PYTHONPATH=src python -m repro_torch.launch.train "
                     "--arch deltakws --steps 100 --batch 64 "
                     "--promote /tmp/deltakws_int8_torch.npz")
SERVE_BUNDLE_CMD = ("PYTHONPATH=src python -m repro_torch.launch.serve "
                    "--mode kws-audio --slots 32 --requests 64 "
                    "--bundle /tmp/deltakws_int8_torch.npz")

# Kernel autotuning on the card ---------------------------------------------
TUNE_CMD = "PYTHONPATH=src python -m repro_torch.kernels.autotune"

ALL_COMMANDS = {
    "torch_tests": TORCH_TESTS_CMD,
    "chip_smoke": CHIP_SMOKE_CMD,
    "quickstart": QUICKSTART_CMD,
    "stream_example": STREAM_EXAMPLE_CMD,
    "train_example": TRAIN_EXAMPLE_CMD,
    "serve": SERVE_CMD,
    "serve_int8": SERVE_INT8_CMD,
    "serve_sync": SERVE_SYNC_CMD,
    "serve_detect": SERVE_DETECT_CMD,
    "serve_cascade": SERVE_CASCADE_CMD,
    "serve_mesh": SERVE_MESH_CMD,
    "serve_faults": SERVE_FAULTS_CMD,
    "train_promote": TRAIN_PROMOTE_CMD,
    "serve_bundle": SERVE_BUNDLE_CMD,
    "tune": TUNE_CMD,
    "lm_tests": LM_TESTS_CMD,
    "serve_lm": SERVE_LM_CMD,
    "train_lm": TRAIN_LM_CMD,
    "lm_train_example": LM_TRAIN_EXAMPLE_CMD,
    "dryrun": DRYRUN_CMD,
    "dryrun_cpu": DRYRUN_CPU_CMD,
}
