"""Spectral-matching correspondence weights (counterpart of `ops/spectral.py`).

The pairwise geometric-consistency affinity of the top-M correspondences
(true pairs preserve intra-cloud distances) and its principal eigenvector,
by a fixed number of power iterations, as Kabsch weights. Deterministic: no
random draw.
"""
from __future__ import annotations

import torch

from .knn import gather_rows
from .ransac import scatter_rows, top_m as _top_m


def spectral_match_weights(src: torch.Tensor, tgt: torch.Tensor, scores: torch.Tensor,
                           top_m: int = 256, sigma: float = 0.09, iters: int = 12,
                           rel_thresh: float = 0.2, eps: float = 1e-12) -> torch.Tensor:
    """Principal-eigenvector consistency weights [..., N] for matched pairs
    src/tgt [..., N, 3]: zero outside the top-M by `scores`, entries below
    rel_thresh·max dropped, normalized to sum 1."""
    scores = scores.float()
    n = scores.shape[-1]
    m = min(int(top_m), n)
    idx = _top_m(scores, m)
    s = gather_rows(src.float(), idx)
    t = gather_rows(tgt.float(), idx)

    def pdist(p):
        d = p[..., :, None, :] - p[..., None, :, :]
        return torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=1e-12))

    c = torch.abs(pdist(s) - pdist(t))
    aff = torch.clamp(1.0 - (c / sigma) ** 2, min=0.0)
    aff = aff * (1.0 - torch.eye(m, dtype=aff.dtype, device=aff.device))
    v = torch.full(aff.shape[:-1], 1.0, device=aff.device) / torch.sqrt(
        torch.tensor(float(m), device=aff.device))
    for _ in range(iters):
        v = (aff @ v[..., None])[..., 0]
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)
    if rel_thresh > 0.0:
        vmax = torch.amax(v, dim=-1, keepdim=True)
        v = torch.where(v > rel_thresh * vmax, v, torch.zeros_like(v))
    w = scatter_rows(v, idx, n)
    return w / (torch.sum(w, dim=-1, keepdim=True) + eps)
