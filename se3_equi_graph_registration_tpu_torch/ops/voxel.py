"""Fixed-shape voxel-grid downsampling (counterpart of `ops/voxel.py`): the
coarse scales of multiscale ICP.

A downsample's natural output size depends on the data; this one keeps a
static shape and marks validity instead, with the JAX package's contract:

- cell ids are ``floor(p / voxel)`` in float32, a true division (not a
  product with 1/voxel, which moves points on a cell face into the next
  cell);
- the occupied cells of every cloud, ordered lexicographically by cell, are
  one ``torch.unique`` over (cloud, qx, qy, qz) rows for the whole batch,
  and their centroids one ``index_add_`` of the points and their counts;
- rows [0, count) hold one centroid per occupied cell; the padding rows
  [count, num_out) replicate the valid centroids cyclically (row j ←
  centroid[j mod count]), so nearest-neighbor queries and rank statistics
  downstream see real locations, never a sentinel;
- with more occupied cells v than ``num_out`` rows, an even spread
  ⌊j·v/num_out⌋ over the cell-ordered run is kept (exact integers up to
  num_out = 46340, above it the float32 spread the JAX package computes).

Solvers zero the padding out of weighted sums through ``mask`` (the prior
weights of `icp_refine_multiscale`'s coarse scales). Centroids agree with
the JAX package's within float32 rounding: the sums run in another order.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["voxel_downsample"]

EXACT_SPREAD_MAX = 46340    # floor(sqrt(2^31)): the JAX package's int32 bound


def voxel_downsample(points: torch.Tensor, voxel_size, num_out: Optional[int] = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Voxel-grid centroids of ``points`` [..., N, 3] at cell edge
    ``voxel_size`` (> 0, a scalar). Returns ``(centroids [..., num_out, 3]
    float32, mask [..., num_out] bool, count [...] int64)``, ``num_out``
    defaulting to N (module docstring). Batched over the leading dimensions
    with no loop over the batch; runs on the points' device."""
    voxel = torch.as_tensor(voxel_size, dtype=torch.float32)
    if voxel.ndim != 0:
        raise ValueError(f"voxel_size must be a scalar, got shape {tuple(voxel.shape)}")
    n = points.shape[-2]
    num_out = n if num_out is None else int(num_out)
    if num_out < 1:
        raise ValueError(f"num_out must be >= 1, got {num_out}")
    lead = points.shape[:-2]
    p = points.reshape((-1, n, 3)).float()
    b, dev = p.shape[0], p.device
    cells = torch.floor(p / voxel.to(dev).expand_as(p)).to(torch.int64)      # [B, N, 3]
    cloud = torch.arange(b, device=dev).repeat_interleave(n)
    rows = torch.cat([cloud[:, None], cells.reshape(-1, 3)], dim=1)            # [B·N, 4]
    uniq, inv = torch.unique(rows, dim=0, return_inverse=True)
    sums = torch.zeros((len(uniq), 3), dtype=torch.float32, device=dev)
    sums.index_add_(0, inv, p.reshape(-1, 3))
    cnts = torch.zeros(len(uniq), dtype=torch.float32, device=dev)
    cnts.index_add_(0, inv, torch.ones_like(inv, dtype=torch.float32))
    cent = sums / cnts[:, None]
    v = torch.bincount(uniq[:, 0], minlength=b)                               # occupied, per cloud
    first = torch.cumsum(v, 0) - v                                           # its first row in uniq
    idx = torch.arange(num_out, device=dev)[None, :]                          # [1, num_out]
    count = torch.clamp(v, max=num_out)
    mask = idx < count[:, None]
    vv = v[:, None]
    if num_out <= EXACT_SPREAD_MAX:
        spread = idx * vv // num_out
    else:
        step = vv.float() / torch.full_like(vv, num_out, dtype=torch.float32)
        spread = torch.floor(idx.float() * step).to(torch.int64)
        spread = torch.minimum(spread, torch.clamp(vv - 1, min=0))
    take = torch.where(vv <= num_out, torch.where(mask, idx, idx % vv), spread)
    out = cent[first[:, None] + take]                                         # [B, num_out, 3]
    return (out.reshape(lead + (num_out, 3)), mask.reshape(lead + (num_out,)),
            count.reshape(lead))
