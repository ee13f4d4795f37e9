"""Per-edge geometric features for the EGNN (counterpart of
`ops/edge_geometry.py`):

  rel    = x_row − x_col                  [..., N, K, 3]
  radial = ‖rel‖²                         [..., N, K, 1]
  dist   = ‖rel‖                          [..., N, K, 1]
  dot    = x_row · x_col                  [..., N, K, 1]
  so3    = 'frame': flattened local frame [a|b|c]  [..., N, K, 9]
           a = rel/‖rel‖, b = (x_row × x_col)/‖·‖, c = a × b;
           degenerate frames become the identity.
           'invariant': nine rotation-invariant functions of
           ‖x_row‖², ‖x_col‖² and x_row · x_col, in the same slot.

`direction` says which endpoint is the row (the aggregation target):
  'center'  → row = center i, col = neighbour j (the fused kernel's layout);
  'cluster' → row = neighbour j, col = center i (the reference's
              torch_cluster orientation).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .numerics import safe_norm, safe_normalize, safe_sqrt, zero_at_zero_sqrt

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


def so3_invariant_features(x_row: torch.Tensor, x_col: torch.Tensor) -> torch.Tensor:
    """Nine rotation-invariant features in the frame's slot (same width, so
    the layer's weights keep their shapes): the raw frame axes rotate with
    the input, these are functions of ‖x_row‖², ‖x_col‖² and x_row · x_col
    alone, which makes the whole EGNN exactly rotation-equivariant. Every
    root is `safe_sqrt` and the last ratio divides by max(‖rel‖², 1e-8), so
    self-loop edges (rel = 0) keep values and gradients finite."""
    r2_row = torch.sum(x_row * x_row, dim=-1)
    r2_col = torch.sum(x_col * x_col, dim=-1)
    dot = torch.sum(x_row * x_col, dim=-1)
    cross2 = torch.clamp(r2_row * r2_col - dot * dot, min=0.0)    # ‖x_row × x_col‖²
    rel2 = torch.clamp(r2_row + r2_col - 2.0 * dot, min=0.0)      # ‖rel‖²
    cos = dot / safe_sqrt(r2_row * r2_col, 1e-12)
    return torch.stack([
        safe_sqrt(r2_row), safe_sqrt(r2_col), dot, safe_sqrt(cross2), safe_sqrt(rel2), cos,
        r2_row - r2_col, safe_sqrt(cross2) / torch.clamp(rel2, min=1e-8),
        torch.ones_like(dot)], dim=-1)


def edge_geometry_from_pairs(x_row: torch.Tensor, x_col: torch.Tensor,
                             so3_mode: str = "frame") -> EdgeGeometry:
    """Geometry of explicit endpoint arrays [..., K, 3] (row = the
    aggregation target, col = the other endpoint)."""
    rel = x_row - x_col
    radial = torch.sum(rel * rel, dim=-1, keepdim=True)
    if so3_mode == "frame":
        so3 = so3_edge_frame(x_row, x_col)
    elif so3_mode == "invariant":
        so3 = so3_invariant_features(x_row, x_col)
    else:
        raise ValueError(f"unknown so3_mode {so3_mode!r}")
    return EdgeGeometry(rel=rel, radial=radial, dist=zero_at_zero_sqrt(radial),
                        dot=torch.sum(x_row * x_col, dim=-1, keepdim=True), so3=so3)


def edge_geometry(x: torch.Tensor, nbr_idx: torch.Tensor, direction: str = "center",
                  so3_mode: str = "frame") -> EdgeGeometry:
    """All per-edge features on the dense [B, N, K] layout, the row and col
    roles as `direction` sets them."""
    x_nbr = gather_neighbors(x, nbr_idx)
    x_center = x[..., :, None, :].expand_as(x_nbr)
    if direction == "center":
        x_row, x_col = x_center, x_nbr
    elif direction == "cluster":
        x_row, x_col = x_nbr, x_center
    else:
        raise ValueError(f"unknown direction {direction!r}")
    return edge_geometry_from_pairs(x_row, x_col, so3_mode)
