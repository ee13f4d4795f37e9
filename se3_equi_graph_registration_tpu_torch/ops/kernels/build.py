"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface, loaded with `ctypes` — no PyTorch
headers, so a build takes seconds. Libraries go to `_build/` inside the
package (ignored by git), named by a hash of the source, every header
`csrc/*.cuh` and the flags, so an edited source or header rebuilds and a
stale library is never loaded.

Nothing builds at import time: the first launch of a kernel builds it, or
`build_all()` builds every source at once, one `nvcc` per source in
parallel.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("knn", "knn_warp", "knn_exact_warp", "knn_chunked", "knn_chunked_warp", "egcl",
           "egcl_tile", "egcl_tile_f32", "egcl_backward", "egcl_backward_tile",
           "egcl_backward_tile_f32", "spfh", "spfh_redux")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the namespace of the kernels' custom ops (`torch.ops.se3gspr_torch`)
OPS = "se3gspr_torch"

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu"), *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str) -> tuple[subprocess.Popen, str, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, _lib_path(name)


def build_all(names: Iterable[str] = SOURCES) -> dict[str, str]:
    """Compile every missing library in parallel; returns {name: nvcc
    output} for the sources built (ptxas register/spill report included).
    Raises with the compiler's output if any build fails."""
    with _lock:
        jobs = {n: _start(n) for n in names if not os.path.exists(_lib_path(n))}
        logs, failed = {}, []
        for n, (proc, tmp, dest) in jobs.items():
            out, _ = proc.communicate()
            logs[n] = out
            if proc.returncode == 0:
                os.replace(tmp, dest)
            else:
                os.unlink(tmp)
                failed.append(f"--- {n}.cu ---\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build_all([name])
        with _lock:
            lib = _loaded.setdefault(name, ctypes.CDLL(path))
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
