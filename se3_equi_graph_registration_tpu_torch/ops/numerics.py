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
