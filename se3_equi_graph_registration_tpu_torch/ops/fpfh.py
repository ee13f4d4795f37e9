"""FPFH-33 descriptors (counterpart of `ops/fpfh.py`).

- `voxel_downsample`: centroid per voxel (host numpy, a copy);
- `estimate_normals`: PCA over the k-NN neighborhood, smallest eigenvector
  by `ops/eig3`, oriented toward a viewpoint or away from the neighborhood
  centroid ('local', pose-equivariant);
- `estimate_normals_window`: the 'local' normals of the fused path from the
  moments cov = Σxxᵀ − K·μμᵀ;
- `fpfh`: the gather formulation (atan2 θ; the source pick's near-ties go
  to the center, `PICK_TIE`); `fpfh_from_spfh` finishes FPFH
  from the fused SPFH kernel (`ops/kernels/spfh.py`):
  FPFH_i = SPFH_i + mean_j SPFH_j / ‖p_i − p_j‖ over valid neighbors.

The reference's banded one-hot matmuls (`_accumulate_window`, the window
moments) are a TPU workaround; the port gathers. Every reduction here is
an elementwise product summed over an axis, never a matmul, so TF32
(`torch.backends.cuda.matmul.allow_tf32`) cannot round the moment
cancellation or the 1/d weights. Functions take clouds [..., N, 3].
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from .eig3 import smallest_eigvec_sym3
from .knn import gather_rows, knn_graph

_BINS = 11
# Rusu's source pick takes the end whose normal makes the smaller angle with
# the edge. Two neighbors whose neighborhoods overlap get normals equal to an
# ulp or two, so the pick, which flips the sign of φ and θ, falls by rounding
# and another device rounds the other way (on the H100 against the CPU: 128
# of 122 880 edges of a 2048-point surface, every gap ≤ 1.2e-7). Within this
# band the center is the source, on every device.
PICK_TIE = 1e-6


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Centroid-per-voxel downsampling (host numpy; data-dependent size)."""
    pts = np.asarray(points, np.float64)
    keys = np.floor(pts / voxel_size).astype(np.int64)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    sums = np.zeros((len(uniq), 3), np.float64)
    np.add.at(sums, inverse, pts)
    counts = np.bincount(inverse, minlength=len(uniq)).astype(np.float64)
    return (sums / counts[:, None]).astype(np.float32)


def _outer_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_k a_k b_kᵀ over axis −2 of [..., K, 3] → [..., 3, 3], elementwise."""
    return torch.sum(a[..., :, :, None] * b[..., :, None, :], dim=-3)


def _orient(normals: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    sign = torch.where(torch.sum(normals * ref, dim=-1) < 0.0, -1.0, 1.0)
    return normals * sign[..., None]


def estimate_normals(x: torch.Tensor, k: int = 30,
                     viewpoint: Optional[torch.Tensor] = None,
                     orient: str = "viewpoint",
                     nbr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unit normals [..., N, 3] from k-NN PCA. orient='viewpoint' points them
    toward `viewpoint` (default the origin); 'local' away from the
    neighborhood centroid. `nbr` [..., N, ≥1] replaces the k-NN (ignoring k)."""
    if orient not in ("viewpoint", "local"):
        raise ValueError(f"unknown orient {orient!r}; expected 'viewpoint' or 'local'")
    if nbr is None:
        nbr = knn_graph(x, min(k, x.shape[-2]))
    nbh = gather_rows(x, nbr)                            # [..., N, K, 3]
    mean = torch.mean(nbh, dim=-2, keepdim=True)
    centered = nbh - mean
    normals = smallest_eigvec_sym3(_outer_sum(centered, centered))
    if orient == "local":
        ref = x - mean[..., 0, :]
    else:
        vp = torch.zeros(3, dtype=x.dtype, device=x.device) if viewpoint is None else viewpoint
        ref = vp - x
    return _orient(normals, ref)


def estimate_normals_window(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """estimate_normals(orient='local') from the neighborhood moments, as
    the fused path computes them: mean = Σx/K, cov = Σxxᵀ − K·μμᵀ, fp32."""
    k = nbr.shape[-1]
    xf = x.to(torch.float32)
    nbh = gather_rows(xf, nbr)
    mean = torch.sum(nbh, dim=-2) / k
    cov = _outer_sum(nbh, nbh) - k * mean[..., :, None] * mean[..., None, :]
    return _orient(smallest_eigvec_sym3(cov), xf - mean)


def fpfh_from_spfh(spfh: torch.Tensor, nbr: torch.Tensor, dist: torch.Tensor
                   ) -> torch.Tensor:
    """FPFH from the fused SPFH kernel's outputs: dist is 0 on the invalid
    (self, duplicate) pairs, exactly the kernel's mask."""
    valid = dist > 0.0
    inv_w = torch.where(valid, 1.0 / (dist + 1e-12), torch.zeros_like(dist))
    counts = torch.clamp(torch.sum(valid, dim=-1, keepdim=True), min=1).to(spfh.dtype)
    neigh = torch.sum(inv_w[..., None] * gather_rows(spfh, nbr), dim=-2) / counts
    return spfh + neigh


def _histogram(values: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """values [..., K] → per-point bin counts [..., BINS] (float32)."""
    t = torch.clamp((values - lo) / (hi - lo), 0.0, 1.0 - 1e-7)
    idx = torch.floor(t * float(_BINS)).to(torch.int64)
    lanes = torch.arange(_BINS, device=values.device)
    return torch.sum(idx[..., None] == lanes, dim=-2).to(values.dtype)


def fpfh(x: torch.Tensor, normals: torch.Tensor, k: int = 30,
         nbr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FPFH-33 descriptors [..., N, 33] over k-NN neighborhoods (the gather
    formulation: Rusu's source pick, Darboux frame, θ by atan2). `nbr`
    replaces the k-NN (ignoring k)."""
    if nbr is None:
        nbr = knn_graph(x, min(k, x.shape[-2]))
    p_j = gather_rows(x, nbr)                            # [..., N, K, 3]
    n_j = gather_rows(normals, nbr)
    n_i = normals[..., :, None, :].expand_as(p_j)
    d = p_j - x[..., :, None, :]
    dist = torch.linalg.vector_norm(d, dim=-1)
    self_mask = dist > 1e-12
    dhat = d / (dist[..., None] + 1e-12)

    cos_i = torch.abs(torch.sum(n_i * dhat, dim=-1))
    cos_j = torch.abs(torch.sum(n_j * dhat, dim=-1))
    take_i = (cos_i >= cos_j - PICK_TIE)[..., None]
    n_s = torch.where(take_i, n_i, n_j)
    n_t = torch.where(take_i, n_j, n_i)
    dvec = torch.where(take_i, dhat, -dhat)
    u = n_s
    v = torch.linalg.cross(dvec, u, dim=-1)
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
    w = torch.linalg.cross(u, v, dim=-1)
    alpha = torch.sum(v * n_t, dim=-1)
    phi = torch.sum(u * dvec, dim=-1)
    theta = torch.atan2(torch.sum(w * n_t, dim=-1), torch.sum(u * n_t, dim=-1))

    mask = self_mask.to(x.dtype)

    def hist(vals, lo, hi):
        h = _histogram(torch.where(self_mask, vals, torch.full_like(vals, lo - 1.0)), lo, hi)
        # masked values land in bin 0 through the clip: take them out again
        h = torch.cat([h[..., :1] - torch.sum(1.0 - mask, dim=-1, keepdim=True), h[..., 1:]], -1)
        total = torch.clamp(torch.sum(h, dim=-1, keepdim=True), min=1e-6)
        return 100.0 * h / total

    spfh = torch.cat([hist(alpha, -1.0, 1.0), hist(phi, -1.0, 1.0),
                      hist(theta, -np.pi, np.pi)], dim=-1)
    inv_w = torch.where(self_mask, 1.0 / (dist + 1e-12), torch.zeros_like(dist))
    counts = torch.clamp(torch.sum(mask, dim=-1, keepdim=True), min=1.0)
    neigh = torch.sum(inv_w[..., None] * gather_rows(spfh, nbr), dim=-2) / counts
    return spfh + neigh


def extract_fpfh_native(points: np.ndarray, voxel_size: float = 0.05,
                        k_normals: int = 30, k_fpfh: int = 60,
                        device: Union[str, torch.device, None] = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Voxel downsample → normals → FPFH-33, no open3d. Returns
    (downsampled points [M, 3], descriptors [M, 33]). Runs on the card
    unless device='cpu'."""
    dev = resolve_device(device)
    pts = voxel_downsample(points, voxel_size)
    x = torch.from_numpy(pts).to(dev)
    with torch.no_grad():
        feats = fpfh(x, estimate_normals(x, k=k_normals), k=k_fpfh)
    return pts, feats.cpu().numpy().astype(np.float32)
