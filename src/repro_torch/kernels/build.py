"""Build the CUDA kernels in ``repro_torch/csrc`` with nvcc and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``_build/<name>-<hash>.so`` (``.gitignore`` lists ``_build/``) on
first use, then loaded with ``ctypes``.  No PyTorch headers are included,
so a build takes seconds, not the minutes of
``torch.utils.cpp_extension.load``.  The hash covers the source and the
flags, so an edited kernel is never served from a stale library.  Only
sources in the repository are compiled; nothing is fetched.

Flags: ``sm_90a`` (Hopper), ``-O3``, ``--fmad=false`` and
``--ftz=true``.  The kernels follow the JAX reference as XLA compiles it
on the CPU: a product is fused into the following add exactly where XLA
fuses it, written as ``fmaf`` in the source, and nowhere else (nvcc would
otherwise contract ``a*b + c`` on its own); and denormals are flushed to
zero, as XLA:CPU runs.  ``-Xptxas -v`` keeps each kernel's register and
shared-memory report in the build log.  The shared headers ``csrc/*.cuh``
are part of every library's hash.

A library key is a source name (``"iir_fex"``) or a variant of one,
``variant("iir_fex", FEX_UNROLL=4)`` = ``"iir_fex+FEX_UNROLL=4"``: the
same source compiled with ``-DFEX_UNROLL=4`` into a library of its own
(the FEx kernels' ``unroll`` instances).  The defines are part of the
hash and of the file name.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("iir_fex", "delta_gru_seq", "iir_fex_int", "delta_gru_seq_int",
           "delta_matvec", "delta_gru_cell", "detect_head", "wake_head")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "--ftz=true", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    """One compiled kernel library: its path, build seconds (0 when it
    was already built) and nvcc's output (ptxas register report)."""

    path: pathlib.Path
    seconds: float
    log: str


def nvcc_path() -> str:
    """The nvcc to use: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    candidates = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                  "/usr/local/cuda"]
    for home in filter(None, candidates):
        p = pathlib.Path(home) / "bin" / "nvcc"
        if p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, "
                           "/usr/local/cuda and PATH): the CUDA kernels "
                           "cannot be built")
    return found


def variant(name: str, **defines) -> str:
    """The key of ``csrc/<name>.cu`` built with ``-D<KEY>=<value>`` for
    each define (``name`` itself when there is none)."""
    return name + "".join(f"+{k}={int(v)}" for k, v in sorted(
        defines.items()))


def _split(key: str) -> tuple[str, list[str]]:
    """A library key → (source name, nvcc -D flags)."""
    name, *defines = key.split("+")
    return name, [f"-D{d}" for d in defines]


def _lib_path(key: str) -> pathlib.Path:
    name, defines = _split(key)
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    flags = " ".join((*NVCC_FLAGS, *defines)).encode()
    digest = hashlib.sha1(src + flags).hexdigest()
    stem = key.replace("+", ".").replace("=", "")
    return BUILD_DIR / f"{stem}-{digest[:12]}.so"


def build(names=KERNELS) -> dict[str, Built]:
    """Compile every library in ``names`` (keys: source names or
    ``variant``s) that is not built yet, one nvcc per library, all started
    together.  Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, Built] = {}
    running = {}
    t0 = time.perf_counter()
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            out[name] = Built(lib, 0.0, "")
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        src, defines = _split(name)
        cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(CSRC / f"{src}.cu")]
        running[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (lib, tmp, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode})\n"
                          f"{log}")
            continue
        os.replace(tmp, lib)
        out[name] = Built(lib, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


_loaded: dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of a key (``csrc/<name>.cu``, or a
    ``variant``), built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``: a refused
    launch never runs, and a later synchronize would not report it."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
