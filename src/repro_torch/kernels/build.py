"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each source ``src/repro_torch/csrc/<name>.cu`` has a plain C interface and
compiles on its own into ``build/kernels/<name>-<hash>.so`` at the root
of the checkout (listed in ``.gitignore``), for ``sm_90a`` (Hopper):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o <lib> <source>

The hash covers the source, the ``csrc`` headers it includes and the
flags, so an edited kernel or header rebuilds and an unchanged one loads
from disk. `build_all` starts one ``nvcc`` per source at once and waits
for all of them. No fast-math: the kernels round like their plain PyTorch
versions, and ``-fmad=false`` keeps the compiler from contracting a
multiply and an add into one rounding.

Nothing here runs when a module is imported; the CPU tests import every
module on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("masked_adam", "topk_mask", "rmsnorm", "flash_attention", "rmsnorm_bwd",
           "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``: its name hashes the source, the
    ``csrc`` headers it includes (``#include "x.cuh"``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = [(CSRC / h.decode()).read_bytes()
               for h in re.findall(rb'#include "([^"]+)"', src)]
    digest = hashlib.sha256(b"".join([src, *headers])
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; None when its library is built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees half a library


def build_all() -> float:
    """Build every kernel source in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in SOURCES}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a non-zero cudaError_t;
    every library exports ``error_string`` to name it."""
    if err != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
