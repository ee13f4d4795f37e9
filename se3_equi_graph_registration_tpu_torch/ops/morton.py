"""Space-filling-curve sorting and window-restricted k-NN graphs
(counterpart of `ops/morton.py`).

Sorting points along a Hilbert (or Morton) curve puts k-NN neighbors near
their center in index space, so each tile of T centers searches only the
curve window [S(i), S(i)+W). The graph is exact *within the window*: an
approximate k-NN graph (window recall ~0.85 at N=2048, k=16, W=384 in the
reference's measurements), and the kernels' input contract.

The reference's `permute_rows_matmul` (a bf16 one-hot matmul gather, a TPU
workaround that rounds h) has no counterpart: the port gathers exactly.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from .knn import pairwise_sq_dists, smallest_k


def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of v over 30: abcdefghij → a00b00c00...j (int32)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Min-max normalize per cloud and quantize to `bits` per axis (int32)."""
    if not 1 <= bits <= 10:
        raise ValueError(f"bit-spread masks support <=10 bits, got {bits}")
    x = x.to(torch.float32)
    lo = torch.amin(x, dim=-2, keepdim=True)
    hi = torch.amax(x, dim=-2, keepdim=True)
    top = float(2 ** bits - 1)
    span = torch.clamp(hi - lo, min=1e-12)
    # a true division: `scalar / tensor` in torch is reciprocal-then-multiply,
    # which can round the extreme point to 1022 instead of 1023
    scale = torch.full_like(span, top) / span
    return torch.clamp((x - lo) * scale, 0.0, top).to(torch.int32)


def _interleave(q0, q1, q2) -> torch.Tensor:
    return ((_expand_bits_10(q0) << 2) | (_expand_bits_10(q1) << 1)
            | _expand_bits_10(q2))


def morton_codes(x: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Morton codes for points x [..., N, 3] → int32 [..., N]."""
    q = _quantize(x, bits)
    return _interleave(q[..., 0], q[..., 1], q[..., 2])


def hilbert_codes(x: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """3D Hilbert-curve codes (Skilling's transpose algorithm), int32."""
    q = _quantize(x, bits)
    X = [q[..., 0], q[..., 1], q[..., 2]]
    M = 1 << (bits - 1)
    Q = M
    while Q > 1:
        P = Q - 1
        for i in range(3):
            cond = (X[i] & Q) != 0
            t = (X[0] ^ X[i]) & P
            x0_new = torch.where(cond, X[0] ^ P, X[0] ^ t)
            X[i] = torch.where(cond, X[i], X[i] ^ t)
            X[0] = x0_new
        Q >>= 1
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[0])
    Q = M
    while Q > 1:
        t = torch.where((X[2] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    X = [xi ^ t for xi in X]
    return _interleave(X[0], X[1], X[2])


def curve_codes(x: torch.Tensor, bits: int = 10,
                curve: str = "hilbert") -> torch.Tensor:
    if curve == "hilbert":
        return hilbert_codes(x, bits)
    if curve == "morton":
        return morton_codes(x, bits)
    raise ValueError(f"unknown curve {curve!r}")


def window_start_at(i: Union[int, torch.Tensor], tile: int, n: int,
                    window: int) -> Union[int, torch.Tensor]:
    """Window start for tile index `i`:
    S(i) = clip(i − pad_tiles, 0, (n − window) // tile) · tile.
    The one definition shared by the window graph functions and both kernels
    (the CUDA sources repeat it from the two integers computed here)."""
    pad_tiles = (window - tile) // 2 // tile if window > tile else 0
    hi = (n - window) // tile
    if isinstance(i, torch.Tensor):
        return torch.clamp(i - pad_tiles, 0, hi) * tile
    return min(max(i - pad_tiles, 0), hi) * tile


def window_starts(n: int, tile: int, window: int,
                  device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """Window start per tile, int64 [n // tile]."""
    if n % tile or window % tile:
        raise ValueError(f"n={n} and window={window} must divide by tile={tile}")
    return window_start_at(torch.arange(n // tile, device=device), tile, n, window)


def window_candidates(x: torch.Tensor, tile: int, window: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split sorted points x [..., N, 3] into query tiles and their windows:
    (queries [..., N/T, T, 3], candidates [..., N/T, W, 3], starts [N/T])."""
    n = x.shape[-2]
    if not (n % tile == 0 and window % tile == 0 and tile <= window <= n):
        raise ValueError(f"bad window geometry n={n} tile={tile} window={window}")
    starts = window_starts(n, tile, window, device=x.device)
    cols = starts[:, None] + torch.arange(window, device=x.device)
    cand = x[..., cols, :]
    queries = x.reshape(x.shape[:-2] + (n // tile, tile, 3))
    return queries, cand, starts


def morton_perm(x: torch.Tensor, curve: str = "hilbert") -> torch.Tensor:
    """The permutation [..., N] sorting points along the space-filling curve
    (default Hilbert; the name is the ROADMAP's 'Morton window'): a stable
    sort of the codes."""
    return torch.sort(curve_codes(x, curve=curve), dim=-1, stable=True).indices


def sort_by_curve(h: torch.Tensor, x: torch.Tensor, curve: str = "hilbert"
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort (h [..., N, C], x [..., N, 3]) along the curve → (hs, xs, perm):
    `morton_perm`, then a gather by the permutation."""
    perm = morton_perm(x, curve)
    hs = torch.take_along_dim(h, perm[..., None], dim=-2)
    xs = torch.take_along_dim(x, perm[..., None], dim=-2)
    return hs, xs, perm


def unsort_rows(arrs: Sequence[torch.Tensor], perm: torch.Tensor
                ) -> tuple[torch.Tensor, ...]:
    """Invert the row permutation: u[..., perm[i], :] = a[..., i, :], as a
    gather by the inverse permutation."""
    iota = torch.arange(perm.shape[-1], device=perm.device).expand_as(perm)
    inv = torch.empty_like(perm).scatter_(-1, perm, iota)
    return tuple(torch.take_along_dim(a, inv[..., None], dim=-2) for a in arrs)


def knn_graph_window(x_sorted: torch.Tensor, k: int, tile: int = 128,
                     window: int = 384) -> torch.Tensor:
    """Exact-within-window k-NN over curve-sorted points x [..., N, 3] →
    nbr_idx int32 [..., N, K] in sorted index space. Every neighbor of tile
    i lies in [S(i), S(i)+window); self matches are included."""
    queries, cand, starts = window_candidates(x_sorted, tile, window)
    d2 = pairwise_sq_dists(queries, cand)                  # [..., N/T, T, W]
    idx = smallest_k(d2, k) + starts[:, None, None]
    return idx.reshape(x_sorted.shape[:-1] + (k,)).to(torch.int32)
