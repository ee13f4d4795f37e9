"""Segment reductions (counterpart of `ops/segment.py`).

- `kregular_sum` / `kregular_mean`: messages laid out [..., N, K, C] reduce
  onto their centers ('center' direction) with a plain sum over K;
- `segment_sum` / `segment_mean`: rows [E, C] into buckets by id, for the
  'cluster' direction, where messages reduce onto the neighbour endpoint.
  They use `index_add`, which sums with atomics on the card: the order of
  the additions there is not fixed, so card and CPU agree to a tolerance,
  not bit for bit.
"""
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


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum rows of `data` [E, C] into `num_segments` buckets by
    `segment_ids` [E]."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean of the rows in each bucket; empty buckets → 0 (the count clamps
    at 1, as the reference's unsorted_segment_mean does)."""
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(data.new_ones(data.shape[:1]), segment_ids, num_segments)
    return total / torch.clamp(count, min=1.0)[:, None]
