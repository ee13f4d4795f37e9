"""Small tensor utilities (counterpart of `utils/nn_extras.py`): the vendored
library's to_order, fourier_encode, masked_mean, batched_index_select and
memo cache, and its rotary embeddings (sinusoidal_embeddings,
apply_rotary_pos_emb), as plain torch functions.
"""
from __future__ import annotations

import functools

import torch


def to_order(degree: int) -> int:
    """Dimension of the degree-d irrep: 2d+1."""
    return 2 * degree + 1


def fourier_encode(x: torch.Tensor, num_encodings: int = 4,
                   include_self: bool = True) -> torch.Tensor:
    """x [..., d] → [..., d·(2·num_encodings (+1))]: sin and cos of x at
    dyadic frequencies x / 2^i, with x itself first when `include_self`."""
    x = x[..., None]
    scales = 2.0 ** torch.arange(num_encodings, dtype=x.dtype, device=x.device)
    xs = x / scales
    enc = torch.cat([torch.sin(xs), torch.cos(xs)], dim=-1)
    if include_self:
        enc = torch.cat([x, enc], dim=-1)
    return enc.reshape(enc.shape[:-2] + (-1,))


def masked_mean(tensor: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Mean over `dim` of the entries where mask is true (an empty row → 0)."""
    mask = mask.to(tensor.dtype)
    total = torch.sum(tensor * mask, dim=dim)
    return total / torch.clamp(torch.sum(mask, dim=dim), min=1.0)


def batched_index_select(values: torch.Tensor, indices: torch.Tensor,
                         dim: int = 1) -> torch.Tensor:
    """Gather along `dim` with per-batch index arrays: indices [..., M]
    (the leading axes of values up to `dim`) pick rows of values, and the
    trailing axes of values come along."""
    idx = indices
    while idx.dim() < values.dim():
        idx = idx[..., None]
    idx = idx.expand(tuple(idx.shape[:dim + 1]) + tuple(values.shape[dim + 1:]))
    return torch.gather(values, dim, idx.long())


def cache(fn):
    """Memoization decorator (the vendored library's `cache`; hashable args)."""
    return functools.lru_cache(maxsize=None)(fn)


# --- rotary embeddings (the vendored utils/rotary.py) ---

def sinusoidal_embeddings(positions: torch.Tensor, dim: int,
                          base: float = 10000.0) -> torch.Tensor:
    """positions [...] → [..., dim]: sin then cos of positions times the
    frequencies base^(−2i/dim), in float32."""
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                            device=positions.device) / dim))
    angles = positions[..., None].to(torch.float32) * inv_freq
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(x: torch.Tensor, sincos: torch.Tensor) -> torch.Tensor:
    """Rotate feature pairs by position-dependent angles."""
    sin, cos = torch.chunk(sincos, 2, dim=-1)
    sin = torch.cat([sin, sin], dim=-1)
    cos = torch.cat([cos, cos], dim=-1)
    return x * cos + rotate_half(x) * sin
