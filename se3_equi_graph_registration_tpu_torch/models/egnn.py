"""SE(3)-equivariant graph network, the readable plain model (counterpart of
`models/egnn.py`) in the 'center' direction with the 'frame' so3 mode.

Edges live in a dense k-regular layout [B, N, K]; aggregation onto centers
is a sum over K. The per-head edge MLPs are fused: one first layer over the
77-d edge input (at C=32), then a block-diagonal second layer. The edge
input concatenates, in the reference's order,
  [h_row, h_col, radial, dist, dot, so3(9), edge_attr(=1)].

Parameter names follow the JAX package's flax tree
(`train/checkpoints.params_from_jax` maps one onto the other). The fused
kernel path (`ops/kernels/egcl.py`) reads the same parameters.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.edge_geometry import edge_geometry, gather_neighbors
from ..ops.segment import kregular_sum

GEO_DIM = 12   # radial, dist, dot, so3(9)


class MultiHeadEdgeMLP(nn.Module):
    """Linear(F→C) → SiLU → per-head Linear(w→w), w = C / heads."""

    def __init__(self, in_dim: int, hidden_nf: int, num_heads: int):
        super().__init__()
        if hidden_nf % num_heads:
            raise ValueError(f"hidden_nf={hidden_nf} must divide by num_heads={num_heads}")
        w = hidden_nf // num_heads
        self.num_heads = num_heads
        self.fused_in = nn.Linear(in_dim, hidden_nf)
        self.head_kernels = nn.Parameter(torch.empty(num_heads, w, w))
        self.head_biases = nn.Parameter(torch.zeros(num_heads, w))
        nn.init.normal_(self.head_kernels, std=w ** -0.5)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.fused_in(feats))
        y = y.reshape(y.shape[:-1] + (self.num_heads, -1))
        y = torch.einsum("...hw,hwv->...hv", y, self.head_kernels) + self.head_biases
        return y.reshape(y.shape[:-2] + (-1,))


class EGCL(nn.Module):
    """One equivariant graph convolution layer ('center', 'frame', sum)."""

    def __init__(self, hidden_nf: int, num_heads: int = 4, edge_attr_dim: int = 1):
        super().__init__()
        self.edge_mlp = MultiHeadEdgeMLP(2 * hidden_nf + GEO_DIM + edge_attr_dim,
                                         hidden_nf, num_heads)
        self.layer_norm = nn.LayerNorm(hidden_nf, eps=1e-5)
        self.coord_mlp_0 = nn.Linear(hidden_nf, hidden_nf)
        self.coord_mlp_out = nn.Linear(hidden_nf, 1, bias=False)
        self.node_mlp_0 = nn.Linear(2 * hidden_nf, hidden_nf)
        self.node_mlp_1 = nn.Linear(hidden_nf, hidden_nf)

    def forward(self, h: torch.Tensor, x: torch.Tensor, nbr_idx: torch.Tensor,
                edge_attr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        geom = edge_geometry(x, nbr_idx)
        h_col = gather_neighbors(h, nbr_idx)
        h_row = h[..., :, None, :].expand_as(h_col)
        edge_in = torch.cat([h_row, h_col, geom.radial, geom.dist, geom.dot,
                             geom.so3, edge_attr], dim=-1)
        m = self.layer_norm(self.edge_mlp(edge_in))
        scale = self.coord_mlp_out(F.silu(self.coord_mlp_0(m)))
        x = x + kregular_sum(geom.rel * scale)
        out = self.node_mlp_0(torch.cat([h, kregular_sum(m)], dim=-1))
        out = self.node_mlp_1(F.silu(out))
        return h + out, x


class EGNN(nn.Module):
    """Embedding → n_layers × EGCL → output embedding.

    h [B, N, in_node_nf], x [B, N, 3], nbr_idx [B, N, K] →
    (h [B, N, out_node_nf], x [B, N, 3]); edge_attr is all ones.
    """

    def __init__(self, in_node_nf: int = 32, hidden_nf: int = 32,
                 out_node_nf: int = 32, n_layers: int = 3, num_heads: int = 4,
                 edge_attr_dim: int = 1):
        super().__init__()
        self.n_layers = n_layers
        self.edge_attr_dim = edge_attr_dim
        self.embedding_in = nn.Linear(in_node_nf, hidden_nf)
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", EGCL(hidden_nf, num_heads, edge_attr_dim))
        self.embedding_out = nn.Linear(hidden_nf, out_node_nf)

    def layers(self) -> list[EGCL]:
        return [getattr(self, f"gcl_{i}") for i in range(self.n_layers)]

    def forward(self, h: torch.Tensor, x: torch.Tensor, nbr_idx: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        edge_attr = torch.ones(nbr_idx.shape + (self.edge_attr_dim,),
                               dtype=h.dtype, device=h.device)
        h = self.embedding_in(h)
        for layer in self.layers():
            h, x = layer(h, x, nbr_idx, edge_attr)
        return self.embedding_out(h), x
