"""PointNet-style k-NN feature encoder (counterpart of `models/pointnet.py`):
the reference's optional end-to-end descriptor learner (`use_pointnet`, off
by default). Two max-aggregation message-passing layers whose messages are
MLP([h_j, x_j − x_i]) (the first layer's is x_j − x_i alone), on the same
dense [B, N, K] neighbour layout as the EGNN, then a linear classifier.

Parameter names follow the JAX package's flax tree: `conv1.dense_0`,
`conv1.dense_1`, `conv2.*`, `classifier`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.edge_geometry import gather_neighbors


class PointNetLayer(nn.Module):
    """One max-aggregation message-passing layer; `in_channels` = 0 takes
    no features (the message is the relative position alone)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.dense_0 = nn.Linear(in_channels + 3, out_channels)
        self.dense_1 = nn.Linear(out_channels, out_channels)

    def forward(self, h: Optional[torch.Tensor], x: torch.Tensor,
                nbr_idx: torch.Tensor) -> torch.Tensor:
        rel = gather_neighbors(x, nbr_idx) - x[..., :, None, :]
        msg_in = rel if h is None else torch.cat([gather_neighbors(h, nbr_idx), rel], dim=-1)
        m = self.dense_1(F.relu(self.dense_0(msg_in)))
        # amax splits the gradient evenly between tied maxima, as jnp.max does
        return torch.amax(m, dim=-2)


class PointNet(nn.Module):
    """x [B, N, 3], nbr_idx [B, N, K] → learned descriptors [B, N, out_channels]."""

    def __init__(self, hidden_channels: int = 32, out_channels: int = 32):
        super().__init__()
        self.conv1 = PointNetLayer(0, hidden_channels)
        self.conv2 = PointNetLayer(hidden_channels, hidden_channels)
        self.classifier = nn.Linear(hidden_channels, out_channels)

    def forward(self, x: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv1(None, x, nbr_idx))
        h = F.relu(self.conv2(h, x, nbr_idx))
        return self.classifier(h)
