"""Maximum-clique correspondence pruning (counterpart of
`native/max_clique.py`): the exact C++ solver and a torch heuristic.

`max_clique.cpp` is the JAX package's source, unchanged, with
the reference's C ABI
`int32 max_clique(nedges, ei, ej, offset, outsize, output) -> size`. It
builds with `g++ -O3 -std=c++17 -shared -fPIC` at first use into the
package's git-ignored `_build/`, named by a hash of the source and the
flags (as `ops/kernels/build.py` names the CUDA libraries), never next to
the source. A failed build raises with the compiler's output; there is no
other solver.

The solver and the consistency graph run on the host in numpy, as in JAX:
the edge test |‖sᵢ−sⱼ‖ − ‖tᵢ−tⱼ‖| < tau in float64, so an edge at the tau
boundary falls the same way as there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np
import torch
from numpy.ctypeslib import ndpointer

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "max_clique.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_fn = None


def _lib_path() -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libpmc-{digest.hexdigest()[:12]}.so")


def build_library() -> str:
    """Compile max_clique.cpp with g++ unless the library for this source
    and these flags exists; returns its path. Raises RuntimeError with the
    compiler's output if the build fails."""
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp],
                         capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, path)
    return path


def _load():
    global _fn
    with _lock:
        if _fn is None:
            fn = ctypes.CDLL(build_library()).max_clique
            fn.restype = ctypes.c_int32
            fn.argtypes = [ctypes.c_int32,
                           ndpointer(ctypes.c_int32, flags="C_CONTIGUOUS"),
                           ndpointer(ctypes.c_int32, flags="C_CONTIGUOUS"),
                           ctypes.c_int32, ctypes.c_int32,
                           ndpointer(ctypes.c_int32, flags="C_CONTIGUOUS")]
            _fn = fn
        return _fn


def max_clique(ei: np.ndarray, ej: np.ndarray, n_nodes: int) -> np.ndarray:
    """Exact maximum clique of the undirected edge list → vertex ids (in the
    solver's order)."""
    ei = np.ascontiguousarray(ei, np.int32)
    ej = np.ascontiguousarray(ej, np.int32)
    output = np.zeros(max(n_nodes, 1), np.int32)
    size = _load()(len(ei), ei, ej, 0, len(output), output)
    return output[:size].copy()


def pmc(ei, ej, nnodes, nnedges) -> np.ndarray:
    """The reference's entry point (utils/max_clique.py:14)."""
    ei = np.asarray(ei, np.int32)[:nnedges]
    ej = np.asarray(ej, np.int32)[:nnedges]
    return max_clique(ei, ej, nnodes)


def consistency_graph(src_pts: np.ndarray, tgt_pts: np.ndarray,
                      tau: float = 0.10) -> tuple[np.ndarray, np.ndarray]:
    """Pairwise length-consistency edges between putative correspondences:
    (i, j), i < j, connected iff |‖sᵢ−sⱼ‖ − ‖tᵢ−tⱼ‖| < tau."""
    ds = np.linalg.norm(src_pts[:, None] - src_pts[None], axis=-1)
    dt = np.linalg.norm(tgt_pts[:, None] - tgt_pts[None], axis=-1)
    ok = np.abs(ds - dt) < tau
    np.fill_diagonal(ok, False)
    ei, ej = np.nonzero(np.triu(ok))
    return ei.astype(np.int32), ej.astype(np.int32)


def max_clique_heuristic(adj: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """Device-side clique heuristic (counterpart of `max_clique_heuristic_jax`):
    iterated weighted-degree peeling. adj [..., N, N] float (symmetric, zero
    diagonal) → a {0,1} mask [..., N] of a (near-)clique: each step drops the
    active vertex least connected to the rest, until the survivors are
    mutually consistent. A fixed step count, so it runs on the card as is.
    It has no caller in either package; it is here because the module has it."""
    n = adj.shape[-1]
    mask = torch.ones(adj.shape[:-1], dtype=adj.dtype, device=adj.device)
    for _ in range(iters):
        active = torch.sum(mask, dim=-1, keepdim=True)
        deg = torch.einsum("...ij,...j->...i", adj, mask) * mask
        complete = torch.all((deg >= active - 1.0) | (mask == 0), dim=-1, keepdim=True)
        worst = torch.argmin(torch.where(mask > 0, deg, torch.full_like(deg, torch.inf)),
                             dim=-1)
        drop = torch.nn.functional.one_hot(worst, n).to(mask.dtype)
        mask = torch.where(complete, mask, mask * (1.0 - drop))
    return mask
