"""Gradient-safe numeric primitives (counterpart of `ops/numerics.py`).

Self-loop edges make ‖Δx‖ = 0 a guaranteed input; these keep values and
gradients finite there, with the reference's epsilons.
"""
from __future__ import annotations

import torch


def safe_sqrt(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """sqrt with a finite gradient at x == 0; value error ≤ sqrt(eps)."""
    return torch.sqrt(torch.clamp(x, min=0.0) + eps)


def zero_at_zero_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt that is exactly 0 at x == 0, with a zero gradient there."""
    positive = x > 0
    safe_x = torch.where(positive, x, torch.ones_like(x))
    return torch.where(positive, torch.sqrt(safe_x), torch.zeros_like(x))


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-20) -> torch.Tensor:
    """L2 norm with a finite gradient at x == 0 (≈ sqrt(eps) there)."""
    return safe_sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim), eps)


def safe_normalize(x: torch.Tensor, dim: int = -1,
                   eps: float = 1e-8) -> torch.Tensor:
    """x / (‖x‖ + eps) with finite gradients everywhere."""
    return x / (safe_norm(x, dim=dim, keepdim=True) + eps)


def quantile(x: torch.Tensor, q: float, method: str = "linear") -> torch.Tensor:
    """`jnp.quantile` over the last axis, keepdims, with JAX's arithmetic:
    position q·(n − 1) in fp32, then low·(1 − f) + high·f ('linear') or
    (low + high)·0.5 ('midpoint', `jnp.median`'s method: the mean of the two
    middle values at even n, where `torch.median` takes the lower one)."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    low, high = s[..., int(lo):int(lo) + 1], s[..., int(hi):int(hi) + 1]
    if method == "midpoint":
        return (low + high) * 0.5
    if method == "linear":
        fw = pos - lo
        return low * (1.0 - fw) + high * fw
    raise ValueError(f"unknown quantile method {method!r}")


def median(x: torch.Tensor) -> torch.Tensor:
    """`jnp.median` over the last axis, keepdims."""
    return quantile(x, 0.5, "midpoint")
