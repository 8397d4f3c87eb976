"""Docs sanity of the port (after ``tests/test_docs.py``): the README's
port commands are real, current and single-sourced.

``repro_torch.commands`` is the port's registry.  Every command in it
appears VERBATIM in a README code block, every file it names exists and
every module imports, the serve, train and tune lines parse against the
port's own parsers, and the examples print the registry (not hand-typed
copies).  The quickstart runs in this process on the CPU at its smallest
flags.
"""
import ast
import contextlib
import importlib
import importlib.util
import io
import pathlib
import re
import shlex

import pytest

from repro_torch import commands

REPO = pathlib.Path(__file__).parent.parent
README = REPO / "README.md"
EXAMPLES = ("torch_quickstart.py", "torch_serve_streaming_kws.py",
            "torch_train_kws_e2e.py", "torch_lm_train.py")


def _code_blocks(text: str) -> str:
    return "\n".join(re.findall(r"```(?:bash|sh)?\n(.*?)```", text, re.S))


def _split_env(cmd: str):
    """Strip leading VAR=VALUE assignments from a documented command."""
    words = shlex.split(cmd)
    while words and re.match(r"^[A-Za-z_][A-Za-z0-9_]*=", words[0]):
        words.pop(0)
    return words


def _flags(cmd: str, module: str):
    words = _split_env(cmd)
    assert words[words.index("-m") + 1] == module, cmd
    return words[words.index(module) + 1:]


@pytest.mark.parametrize("name", sorted(commands.ALL_COMMANDS))
def test_every_port_command_is_documented(name):
    cmd = commands.ALL_COMMANDS[name]
    assert cmd in _code_blocks(README.read_text()), (
        f"README.md code blocks are missing the port's canonical {name!r} "
        f"command:\n  {cmd}\n(repro_torch/commands.py is the single source "
        f"of truth — update both together)")


def test_documented_files_exist_and_modules_import():
    for cmd in commands.ALL_COMMANDS.values():
        words = _split_env(cmd)
        for w in words:
            if w.endswith(".py"):        # a path, or a glob of test files
                assert list(REPO.glob(w)), f"{cmd!r} references missing {w}"
        if "-m" in words:
            mod = words[words.index("-m") + 1]
            if mod != "pytest":
                importlib.import_module(mod)


def test_serve_commands_parse_against_the_port_cli():
    from repro_torch.launch import serve
    parser = serve.build_parser()
    for cmd, mode in (
            (commands.SERVE_CMD, "kws-audio"),
            (commands.SERVE_INT8_CMD, "kws-audio"),
            (commands.SERVE_SYNC_CMD, "kws-audio"),
            (commands.SERVE_FAULTS_CMD, "kws-audio"),
            (commands.SERVE_BUNDLE_CMD, "kws-audio"),
            (commands.SERVE_DETECT_CMD, "kws-detect"),
            (commands.SERVE_CASCADE_CMD, "kws-cascade")):
        args = parser.parse_args(_flags(cmd, "repro_torch.launch.serve"))
        serve.validate_args(args)
        assert args.mode == mode, cmd
        assert args.device == "cuda" and args.train_steps == 120
        if cmd is commands.SERVE_INT8_CMD:
            assert args.numerics == "int8"
        if cmd is commands.SERVE_SYNC_CMD:
            assert args.sync_loop
        if cmd is commands.SERVE_FAULTS_CMD:
            assert args.faults and args.degrade_thresholds
    words = _split_env(commands.SERVE_BUNDLE_CMD)
    assert words[words.index("--bundle") + 1].endswith(".npz")


def test_train_command_parses_and_feeds_the_bundle_command():
    from repro_torch.launch import train
    args = train.build_parser().parse_args(
        _flags(commands.TRAIN_PROMOTE_CMD, "repro_torch.launch.train"))
    assert args.arch == "deltakws" and args.promote and args.steps > 0
    words = _split_env(commands.SERVE_BUNDLE_CMD)
    assert words[words.index("--bundle") + 1] == args.promote


def test_dryrun_commands_parse_against_the_port_cli():
    from repro_torch.launch import dryrun
    parser = dryrun.build_parser()
    card = parser.parse_args(_flags(commands.DRYRUN_CMD,
                                    "repro_torch.launch.dryrun"))
    cpu = parser.parse_args(_flags(commands.DRYRUN_CPU_CMD,
                                   "repro_torch.launch.dryrun"))
    assert (card.all, card.mesh, card.device) == (True, "both", "cuda")
    assert (cpu.all, cpu.mesh, cpu.device) == (True, "both", "cpu")
    assert card.out == cpu.out == "results/torch_dryrun.json"


def test_tune_command_parses():
    from repro_torch.kernels import autotune
    args = autotune.build_parser().parse_args(
        _flags(commands.TUNE_CMD, "repro_torch.kernels.autotune"))
    assert (args.slots, args.chunk_samples, args.device) == (256, 4096,
                                                             "cuda")


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_print_the_registry_and_stand_alone(name):
    src = (REPO / "examples" / name).read_text()
    assert "from repro_torch import commands" in src
    assert re.search(r"commands\.[A-Z_]+_CMD", src)
    mods = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert not mods & {"jax", "jaxlib", "repro", "benchmarks"}, mods
    assert any(f"examples/{name}" in c
               for c in commands.ALL_COMMANDS.values())


def test_readme_says_how_to_tune_and_where_the_cache_lives():
    text = README.read_text()
    port = text[text.index("## PyTorch/CUDA port"):]
    for needle in ("REPRO_AUTOTUNE_CACHE", "kernel_tuning_report",
                   "~/.cache/repro-deltakws/autotune.json",
                   commands.TUNE_CMD):
        assert needle in port, needle
    assert "ring of pinned buffers" not in port
    assert "--stream-seed" not in text


def test_quickstart_runs_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", REPO / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(["--steps", "1", "--batch", "2", "--eval-n", "2",
                       "--device", "cpu"])
    out = buf.getvalue()
    assert rc == 0
    assert "step    0" in out and "Δ_TH" in out
    for cmd in (commands.STREAM_EXAMPLE_CMD, commands.SERVE_CMD,
                commands.TUNE_CMD):
        assert cmd in out


def test_lm_train_example_runs_on_the_cpu_and_its_loss_falls():
    """``examples/torch_lm_train.py`` (the command the registry and the
    README show) at small flags on the CPU: the loss falls, as the
    reference's example asserts, and it prints its command."""
    spec = importlib.util.spec_from_file_location(
        "torch_lm_train", REPO / "examples" / "torch_lm_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    flags = _flags(commands.LM_TRAIN_EXAMPLE_CMD.replace(
        "python examples/torch_lm_train.py", "python -m x"), "x")
    assert mod.build_parser().parse_args(flags).arch == "qwen2-0.5b"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(["--steps", "12", "--batch", "4", "--seq", "32",
                       "--device", "cpu"])
    out = buf.getvalue()
    assert rc == 0, out
    assert "qwen2-0.5b: loss" in out and commands.LM_TRAIN_EXAMPLE_CMD in out
