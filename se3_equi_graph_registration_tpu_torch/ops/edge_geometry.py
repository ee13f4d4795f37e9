"""Per-edge geometric features for the EGNN (counterpart of
`ops/edge_geometry.py`), for the 'center' direction and the 'frame' so3 mode:

  rel    = x_row − x_col                  [..., N, K, 3]
  radial = ‖rel‖²                         [..., N, K, 1]
  dist   = ‖rel‖                          [..., N, K, 1]
  dot    = x_row · x_col                  [..., N, K, 1]
  so3    = flattened local frame [a|b|c]  [..., N, K, 9]
           a = rel/‖rel‖, b = (x_row × x_col)/‖·‖, c = a × b;
           degenerate frames become the identity.

Row = center i (the aggregation target), col = neighbor j.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .numerics import safe_norm, safe_normalize, zero_at_zero_sqrt

_EPS = 1e-8
_DEGEN_THRESHOLD = 1e-6


class EdgeGeometry(NamedTuple):
    rel: torch.Tensor
    radial: torch.Tensor
    dist: torch.Tensor
    dot: torch.Tensor
    so3: torch.Tensor


def gather_neighbors(values: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """values [B, N, C] at nbr_idx [B, N, K] → [B, N, K, C]."""
    b, n, k = nbr_idx.shape
    flat = nbr_idx.reshape(b, n * k).long()
    out = torch.take_along_dim(values, flat[..., None], dim=1)
    return out.reshape(b, n, k, values.shape[-1])


def so3_edge_frame(x_row: torch.Tensor, x_col: torch.Tensor) -> torch.Tensor:
    """Per-edge local SO(3) frame flattened to [a0,b0,c0,a1,b1,c1,a2,b2,c2];
    near-degenerate frames (self-loops, collinear points) become I."""
    rel_n = safe_normalize(x_row - x_col, eps=_EPS)
    cross_n = safe_normalize(torch.linalg.cross(x_row, x_col, dim=-1), eps=_EPS)
    c = torch.linalg.cross(rel_n, cross_n, dim=-1)
    degenerate = ((safe_norm(rel_n) < _DEGEN_THRESHOLD)
                  | (safe_norm(cross_n) < _DEGEN_THRESHOLD)
                  | (safe_norm(c) < _DEGEN_THRESHOLD))
    frame = torch.stack([rel_n, cross_n, c], dim=-1)       # [..., 3, 3(a,b,c)]
    eye = torch.eye(3, dtype=frame.dtype, device=frame.device).expand_as(frame)
    frame = torch.where(degenerate[..., None, None], eye, frame)
    return frame.reshape(frame.shape[:-2] + (9,))


def edge_geometry(x: torch.Tensor, nbr_idx: torch.Tensor) -> EdgeGeometry:
    """All per-edge features on the dense [B, N, K] layout, 'center'/'frame'."""
    x_col = gather_neighbors(x, nbr_idx)
    x_row = x[..., :, None, :].expand_as(x_col)
    rel = x_row - x_col
    radial = torch.sum(rel * rel, dim=-1, keepdim=True)
    return EdgeGeometry(rel=rel, radial=radial, dist=zero_at_zero_sqrt(radial),
                        dot=torch.sum(x_row * x_col, dim=-1, keepdim=True),
                        so3=so3_edge_frame(x_row, x_col))
