"""Dense k-NN graph construction (counterpart of `ops/knn.py`).

The graph is a dense k-regular neighbor table ``nbr_idx [..., N, K]``: for
every point, the indices of its K nearest points, self included when
``include_self=True`` (torch_cluster ``loop=True`` parity).

For large clouds `knn_tiled` computes the same graph a tile of query rows at
a time, so the whole [N, N] distance matrix never exists at once.
"""
from __future__ import annotations

import torch


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """‖x‖² over the last axis of [..., 3], summed in a fixed order
    ((x0² + x1²) + x2²) so every version of the k-NN computes the same bits."""
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]


def cross_dots(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x·y for x [..., N, 3], y [..., M, 3] → [..., N, M], in the same fixed
    order as `sq_norms` (elementwise, no matmul: the CUDA kernel repeats this
    order with round-to-nearest multiplies and adds)."""
    xe, ye = x[..., :, None, :], y[..., None, :, :]
    return (xe[..., 0] * ye[..., 0] + xe[..., 1] * ye[..., 1]) + xe[..., 2] * ye[..., 2]


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances [..., N, M] = ‖x‖² − 2x·y + ‖y‖², clamped at 0
    against cancellation. Works for any feature width D."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    cross = torch.matmul(x, y.transpose(-1, -2))
    d2 = x2 - 2.0 * cross + y2.transpose(-1, -2)
    return torch.clamp(d2, min=0.0)


def smallest_k(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries along the last axis, ties broken by
    the lowest index (what `lax.top_k` on −d² gives): a stable sort."""
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


def gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [..., N, C], idx [..., *I] (indices into N) → [..., *I, C]."""
    lead = idx.shape[:a.dim() - 2]
    flat = idx.reshape(lead + (-1, 1)).to(torch.int64)
    out = torch.gather(a, -2, flat.expand(lead + (flat.shape[-2], a.shape[-1])))
    return out.reshape(idx.shape + (a.shape[-1],))


def knn_graph(x: torch.Tensor, k: int, include_self: bool = True,
              method: str = "exact") -> torch.Tensor:
    """Dense exact k-NN: nbr_idx [..., N, K] int32.

    method='approx' selects the exact sets as well: the reference's
    `approx_min_k` is a TPU unit with no counterpart here, and on the CPU it
    returns the exact sets.
    """
    if method not in ("exact", "approx"):
        raise ValueError(f"unknown knn method {method!r}")
    n = x.shape[-2]
    d2 = pairwise_sq_dists(x, x)
    if not include_self:
        eye = torch.eye(n, dtype=torch.bool, device=x.device)
        d2 = d2.masked_fill(eye, float("inf"))
    return smallest_k(d2, k).to(torch.int32)


def knn_tiled(x: torch.Tensor, k: int, include_self: bool = True,
              tile: int = 1024) -> torch.Tensor:
    """Row-tiled exact k-NN: the sets of `knn_graph`, ties broken at the
    lowest index, with peak memory O(tile·N) instead of O(N²). N must
    divide by `tile`."""
    n = x.shape[-2]
    if n % tile:
        raise ValueError(f"N={n} must be divisible by tile={tile}")
    out = []
    for start in range(0, n, tile):
        d2 = pairwise_sq_dists(x[..., start:start + tile, :], x)     # [..., tile, N]
        if not include_self:
            rows = torch.arange(start, start + tile, device=x.device)
            d2 = d2.masked_fill(rows[:, None] == torch.arange(n, device=x.device), float("inf"))
        out.append(smallest_k(d2, k))
    return torch.cat(out, dim=-2).to(torch.int32)


def nbr_to_edge_list(nbr_idx: torch.Tensor, direction: str = "center"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """A dense neighbor table [..., N, K] as an edge list (row, col), each
    [..., N·K]: 'center' gives row = the center i, col = its neighbor j (the
    EGNN's aggregation onto the query point); 'cluster' the reverse, the
    torch_cluster `knn_graph(flow='source_to_target')` orientation whose
    aggregation target is edge_index[0]."""
    n, k = nbr_idx.shape[-2:]
    centers = torch.arange(n, dtype=torch.int32, device=nbr_idx.device)[:, None]
    centers = centers.expand(nbr_idx.shape).reshape(nbr_idx.shape[:-2] + (n * k,))
    nbrs = nbr_idx.reshape(nbr_idx.shape[:-2] + (n * k,))
    if direction == "center":
        return centers, nbrs
    if direction == "cluster":
        return nbrs, centers
    raise ValueError(f"unknown direction {direction!r}")
