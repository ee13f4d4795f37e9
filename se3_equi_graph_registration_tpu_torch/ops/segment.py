"""k-regular reductions (counterpart of `ops/segment.py`): messages laid out
[..., N, K, C] reduce onto their centers with a plain sum over K."""
from __future__ import annotations

from typing import Optional

import torch


def kregular_sum(messages: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum over the K axis → [..., N, C]; `mask` [..., N, K] zeroes edges."""
    if mask is not None:
        messages = messages * mask[..., None].to(messages.dtype)
    return torch.sum(messages, dim=-2)


def kregular_mean(messages: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the K axis honoring the mask; empty neighborhoods → 0."""
    if mask is None:
        return torch.mean(messages, dim=-2)
    m = mask[..., None].to(messages.dtype)
    return torch.sum(messages * m, dim=-2) / torch.clamp(torch.sum(m, dim=-2), min=1.0)
