"""Fused SPFH (Darboux-angle histograms) over a window neighbor table: the
CUDA kernels of B5 and their plain version (counterpart of
`ops/pallas/spfh_kernel.py`, `spfh_pallas`). Every launch takes
`csrc/spfh_redux.cu` ('redux': bin counts packed in registers, summed by
warp reductions) unless `variant='ballot'` asks for `csrc/spfh.cu` (counts
by warp ballots, kept to compare); `spfh.launches_by_variant` counts each.

Per edge (i, j = nbr[i, k]) with d = x_j − x_i: the edge is valid when
d² > 1e-12 (the self pair and exact duplicates are not); the source of the
Darboux frame is the end whose normal makes the smaller angle with d̂; then
u = n_s, v = (d̂ × u) / (√(‖·‖² + 1e-24) + 1e-12), w = u × v, and
α = v·n_t, φ = u·d̂, θ = atan2(w·n_t, u·n_t). α and φ fall in 11 bins by
floor(clip(t, 0, 1 − 1e-7)·11); θ by the TPU kernel's sector half-plane
tests against 12 boundary directions (so the bins match the fused kernel's
exactly, fp noise at a boundary included). Each center's 33 counts of valid
edges are scaled by 100 / (its valid count from the α channel). Outputs:
SPFH [B, N, 33] and the edge distances [B, N, K], 0 on invalid edges.

accurate=False is the TPU's DEFAULT-precision gather: x and the normals are
rounded to bf16 before the same computation.

Every product and sum is written out in a fixed order, with no matmul, so
the kernels (round-to-nearest intrinsics, no FMA contraction) and this
version agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .knn import _geometry
from . import build
from .build import OPS

BINS = 11
_CLIP_HI = 1.0 - 1e-7


def _sector_constants() -> tuple[np.ndarray, np.ndarray]:
    """(cos θ_b, sin θ_b) float32 [12] of the bin boundaries
    θ_b = −π + b·2π/11, with the seam at ±π exact (cos −1, sin 0)."""
    ang = -np.pi + (2.0 * np.pi / BINS) * np.arange(BINS + 1)
    cs, sn = np.cos(ang), np.sin(ang)
    cs[0] = cs[-1] = -1.0
    sn[0] = sn[-1] = 0.0
    return cs.astype(np.float32), sn.astype(np.float32)


_COS, _SIN = _sector_constants()
_SECTOR = np.concatenate([_COS, _SIN])   # the kernels' host float[24]
# the kernels by variant: csrc/<source>.cu, launched by <source>_launch
SOURCES = {"redux": "spfh_redux", "ballot": "spfh"}
VARIANTS = tuple(SOURCES)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as the kernels' IEEE `sqrtf`:
    torch's float32 sqrt on the CPU is not on every build (an AVX-512 build
    rounds ~0.6% of values the other way), so the root is taken in float64
    and rounded once (exact: float64 holds more than twice float32's bits)."""
    return torch.sqrt(a.double()).to(a.dtype)


def _bins(vals: torch.Tensor) -> torch.Tensor:
    """Bin index of values in [−1, 1] (int64)."""
    t = torch.clamp((vals + 1.0) / 2.0, 0.0, _CLIP_HI)
    return torch.floor(t * float(BINS)).to(torch.int64)


def round_bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).to(torch.float32)


def spfh_plain(x: torch.Tensor, normals: torch.Tensor, nbr: torch.Tensor,
               tile: int = 128, window: int = 768, accurate: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B5 (the window only validates the geometry:
    a gather needs no window)."""
    _check(x, normals, nbr, tile, window)
    if not accurate:
        x, normals = round_bf16(x), round_bf16(normals)
    b, n, k = nbr.shape
    idx = nbr.to(torch.int64).reshape(b, n * k, 1).expand(b, n * k, 3)
    pj = torch.gather(x, 1, idx).reshape(b, n, k, 3)
    nj = torch.gather(normals, 1, idx).reshape(b, n, k, 3)
    pi = x[:, :, None, :].expand_as(pj)
    ni = normals[:, :, None, :].expand_as(nj)

    d = pj - pi
    d2 = _dot(d, d)
    valid = d2 > 1e-12
    dist = _sqrt(d2)
    dhat = d / (dist + 1e-12)[..., None]
    take_i = (torch.abs(_dot(ni, dhat)) >= torch.abs(_dot(nj, dhat)))[..., None]
    u = torch.where(take_i, ni, nj)                        # n_s
    n_t = torch.where(take_i, nj, ni)
    dvec = torch.where(take_i, dhat, -dhat)
    v = _cross(dvec, u)
    v = v / (_sqrt(_dot(v, v) + 1e-24) + 1e-12)[..., None]
    w = _cross(u, v)
    alpha, phi = _dot(v, n_t), _dot(u, dvec)
    ty, tx = _dot(w, n_t), _dot(u, n_t)

    cs = torch.from_numpy(_COS).to(x.device)
    sn = torch.from_numpy(_SIN).to(x.device)
    cross = cs * ty[..., None] - sn * tx[..., None]         # [B, N, K, 12]
    hit_t = (cross[..., :BINS] >= 0.0) & (cross[..., 1:] < 0.0)
    lanes = torch.arange(BINS, device=x.device)
    vm = valid[..., None]
    hist = torch.cat([((_bins(alpha)[..., None] == lanes) & vm).sum(-2),
                      ((_bins(phi)[..., None] == lanes) & vm).sum(-2),
                      (hit_t & vm).sum(-2)], dim=-1).to(torch.float32)
    total = hist[..., :BINS].sum(-1, keepdim=True)
    # 100 / count as torch's `100.0 / t` computes it, rounded twice: the
    # reciprocal, then the product (the kernels round the same two steps)
    scale = torch.reciprocal(torch.clamp(total, min=1e-6)) * 100.0
    return hist * scale, torch.where(valid, dist, torch.zeros_like(dist))


def _check(x, normals, nbr, tile, window):
    if (x.dim() != 3 or x.shape[-1] != 3 or normals.shape != x.shape
            or nbr.dim() != 3 or nbr.shape[:2] != x.shape[:2]):
        raise ValueError(f"want x, normals [B, N, 3] and nbr [B, N, K]; got "
                         f"{tuple(x.shape)}, {tuple(normals.shape)}, {tuple(nbr.shape)}")
    if x.dtype != torch.float32 or normals.dtype != torch.float32:
        raise ValueError("x and normals must be float32")
    _geometry(x.shape[1], tile, window, False, nbr.shape[-1])


def spfh(x: torch.Tensor, normals: torch.Tensor, nbr: torch.Tensor,
         tile: int = 128, window: int = 768, accurate: bool = True,
         variant: Optional[str] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """SPFH-33 [B, N, 33] and edge distances [B, N, K] of curve-sorted
    clouds x [B, N, 3] with unit normals, over nbr [B, N, K] int32 from the
    window k-NN at the same tile/window. A CPU tensor takes the plain
    version; a CUDA tensor launches `csrc/spfh_redux.cu`, or with
    `variant='ballot'` the ballot kernel `csrc/spfh.cu` kept to compare (a
    variant on a CPU tensor raises), through the custom op
    `se3gspr_torch::spfh`."""
    if variant not in (None, *VARIANTS):
        raise ValueError(f"no {variant!r} SPFH kernel; have {VARIANTS}")
    if x.device.type == "cpu":
        if variant is not None:
            raise ValueError("a CPU tensor takes the plain version; variant names a CUDA kernel")
        return spfh_plain(x, normals, nbr, tile, window, accurate)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, normals, nbr, tile, window)
    if nbr.dtype != torch.int32:
        raise ValueError("nbr must be int32")
    if not (x.is_contiguous() and normals.is_contiguous() and nbr.is_contiguous()):
        raise ValueError("x, normals and nbr must be contiguous")
    return spfh_op(x, normals, nbr, tile, window, accurate, variant or "redux")


def run_spfh(x: torch.Tensor, normals: torch.Tensor, nbr: torch.Tensor, tile: int,
             window: int, accurate: bool, variant: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA side of `se3gspr_torch::spfh`: allocates the outputs,
    launches the variant's kernel and counts the launch."""
    b, n, k = nbr.shape
    w, pad_tiles, max_tile = _geometry(n, tile, window, False, k)
    out = torch.empty((b, n, 3 * BINS), dtype=torch.float32, device=x.device)
    dist = torch.empty((b, n, k), dtype=torch.float32, device=x.device)
    ints = (b, n, k, tile, w, pad_tiles, max_tile)
    if variant == "redux":        # fast mode rounds to bf16 inside the kernel
        ints += (int(accurate),)
    elif not accurate:
        x, normals = round_bf16(x), round_bf16(normals)
    symbol = f"{SOURCES[variant]}_launch"
    fn = getattr(build.load(SOURCES[variant]), symbol)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), normals.data_ptr(), nbr.data_ptr(), out.data_ptr(),
                 dist.data_ptr(), _SECTOR.ctypes.data, *ints, stream)
    build.check(err, symbol)
    spfh.launches += 1
    spfh.launches_by_variant[variant] += 1
    return out, dist


spfh.launches = 0
spfh.launches_by_variant = dict.fromkeys(VARIANTS, 0)
spfh_op = torch.library.custom_op(OPS + "::spfh", run_spfh, mutates_args=(),
                                  device_types="cuda")


@spfh_op.register_fake
def _(x, normals, nbr, tile, window, accurate, variant):
    return x.new_empty(nbr.shape[:2] + (3 * BINS,)), x.new_empty(nbr.shape)


def occupancy(variant: str, b: int, n: int, k: int, tile: int, window: int,
              device=None) -> tuple[int, int]:
    """(resident blocks an SM holds, blocks in the grid) of the variant's
    kernel at this geometry (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    per_sm, grid = ctypes.c_int(0), ctypes.c_int(0)
    symbol = f"{SOURCES[variant]}_occupancy"
    fn = getattr(build.load(SOURCES[variant]), symbol)
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        build.check(fn(b, n, k, tile, window, ctypes.addressof(per_sm), ctypes.addressof(grid)),
                    symbol)
    return per_sm.value, grid.value
