"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes). Libraries land in
``build/kernels/`` at the repo root (listed in ``.gitignore``), named by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source rebuilds and an unchanged one is reused.
:func:`build` runs one ``nvcc`` per missing library, all at once.
Importing this module builds nothing.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` and no ``--use_fast_math``: the kernels are held
bit-exactly (z-buffers) or to f32 tolerances (convs) against their
PyTorch twins, which fast math would break. What nvcc prints (warnings)
goes to stdout.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

__all__ = ["load", "build", "build_seconds", "CSRC", "BUILD_DIR"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# seconds spent in nvcc per library this process (0.0 when cached)
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build read_tpu_torch's CUDA kernels")
    return found


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names) -> None:
    """Build the libraries of ``csrc/<name>.cu`` for every name that has
    none yet, one ``nvcc`` process each, all started together."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            build_seconds.setdefault(name, 0.0)
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        src = os.path.join(CSRC, f"{name}.cu")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, src, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, out, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src}:\n{log}")
            continue
        if log.strip():  # warnings
            print(f"[nvcc {name}]\n{log.strip()}", flush=True)
        os.replace(tmp, out)
        build_seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_target(name))
        _LIBS[name] = lib
    return lib


_FUNCTIONS: Dict[tuple, ctypes._CFuncPtr] = {}


def function(lib_name: str, fn_name: str, argtypes: list):
    """C entry point ``fn_name`` of ``csrc/<lib_name>.cu``, typed (once a
    process: the wrappers call this per launch). Every entry point returns
    ``cudaGetLastError()`` after its launch."""
    fn = _FUNCTIONS.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(load(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[(lib_name, fn_name)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a kernel launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error "
                           f"code {err}")
