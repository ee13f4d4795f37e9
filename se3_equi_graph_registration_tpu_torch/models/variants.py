"""The model zoo beyond the registration model (counterpart of
`models/variants.py`), as `nn.Module`s on the dense [B, N, K] neighbor
layout (the legacy GCN on a dense [B, N, N] adjacency):

- `SO3TensorProductLayer`: an MLP over M Mᵀ of flattened 3x3 edge frames;
- `CleanEGCL` / `CleanEGNN`: the standalone "clean" variant: an edge MLP
  plus the tensor-product layer over the edge frames, a node MLP that also
  sees the mean relative position, mean coordinate aggregation;
- `GCL` / `GCLrf` / `ClofGCL`: the vgsatorras-EGNN / ClofNet zoo: a plain
  graph convolution, the radial-field layer, and the local-frame
  (scalarization) layer with updates in the 3-vector frame basis;
- `EGCLVel`: the EGCL with a velocity channel;
- `GraphConvolution`, `build_gaussian_adjacency`, `GlobalPooling`: the
  legacy dense-adjacency GCN path.

flax's `Dense` infers its input width and `nn.Linear` cannot, so every
constructor takes its input widths. Submodules carry the flax names
(`gcl_0.edge_mlp_0`, `so3_tp.dense_0`, ...), so
`train/checkpoints.dense_params_from_jax` turns a flax tree of these
modules into a state_dict that loads strictly. Inputs carry a batch axis.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.edge_geometry import edge_geometry, gather_neighbors
from ..ops.numerics import safe_norm, safe_normalize
from ..ops.segment import kregular_mean, kregular_sum


def _rows(values: torch.Tensor, nbr_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(values at the centers broadcast over K, values at the neighbours),
    each [B, N, K, C]."""
    at_nbr = gather_neighbors(values, nbr_idx)
    return values[..., :, None, :].expand_as(at_nbr), at_nbr


class SO3TensorProductLayer(nn.Module):
    """An MLP over M Mᵀ of per-edge d×d frames: [..., d·d] → [..., output_dim]."""

    def __init__(self, input_dim: int = 3, output_dim: int = 32):
        super().__init__()
        self.input_dim = input_dim
        self.dense_0 = nn.Linear(input_dim * input_dim, 2 * output_dim)
        self.dense_1 = nn.Linear(2 * output_dim, output_dim)

    def forward(self, flat_frames: torch.Tensor) -> torch.Tensor:
        d = self.input_dim
        M = flat_frames.reshape(flat_frames.shape[:-1] + (d, d))
        tp = torch.einsum("...ij,...kj->...ik", M, M)          # M Mᵀ
        tp = tp.reshape(flat_frames.shape[:-1] + (d * d,))
        return self.dense_1(F.relu(self.dense_0(tp)))


class CleanEGCL(nn.Module):
    """The 'clean' EGCL: edge MLP plus the SO(3) tensor-product layer over
    the edge frames; the node MLP also sees the mean relative position;
    coordinates aggregate with the mean. h [B, N, node_nf] (node_nf =
    hidden_nf, as the residual needs)."""

    def __init__(self, hidden_nf: int = 32, node_nf: Optional[int] = None,
                 act: Callable = F.silu):
        super().__init__()
        node_nf = hidden_nf if node_nf is None else node_nf
        self.act = act
        self.edge_mlp_0 = nn.Linear(2 * node_nf + 2, hidden_nf)
        self.so3_tp = SO3TensorProductLayer(3, hidden_nf)
        self.coord_mlp_0 = nn.Linear(hidden_nf, hidden_nf)
        self.coord_mlp_out = nn.Linear(hidden_nf, 1, bias=False)
        self.node_mlp_0 = nn.Linear(node_nf + hidden_nf + 3, hidden_nf)
        self.node_mlp_1 = nn.Linear(hidden_nf, hidden_nf)

    def forward(self, h: torch.Tensor, x: torch.Tensor, nbr_idx: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
        geom = edge_geometry(x, nbr_idx, direction="center", so3_mode="frame")
        h_row, h_nbr = _rows(h, nbr_idx)
        m = self.act(self.edge_mlp_0(torch.cat([h_row, h_nbr, geom.radial, geom.dist], -1)))
        m = m + self.so3_tp(geom.so3)
        scale = self.coord_mlp_out(self.act(self.coord_mlp_0(m)))
        x = x + kregular_mean(geom.rel * scale, edge_mask)
        out = torch.cat([h, kregular_sum(m, edge_mask), kregular_mean(geom.rel, edge_mask)], -1)
        out = self.node_mlp_1(self.act(self.node_mlp_0(out)))
        return h + out, x


class CleanEGNN(nn.Module):
    """Embedding → n_layers × CleanEGCL → output embedding."""

    def __init__(self, in_node_nf: int = 32, hidden_nf: int = 32, out_node_nf: int = 32,
                 n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.embedding_in = nn.Linear(in_node_nf, hidden_nf)
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", CleanEGCL(hidden_nf))
        self.embedding_out = nn.Linear(hidden_nf, out_node_nf)

    def forward(self, h: torch.Tensor, x: torch.Tensor, nbr_idx: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
        h = self.embedding_in(h)
        for i in range(self.n_layers):
            h, x = getattr(self, f"gcl_{i}")(h, x, nbr_idx, edge_mask)
        return self.embedding_out(h), x


class GCL(nn.Module):
    """A plain (not equivariant) graph convolution: h [B, N, in_nf] →
    h + node_mlp([h, Σ edge_mlp([h_i, h_j])])."""

    def __init__(self, in_nf: int, hidden_nf: int = 32, act: Callable = F.silu):
        super().__init__()
        self.act = act
        self.edge_mlp_0 = nn.Linear(2 * in_nf, hidden_nf)
        self.edge_mlp_1 = nn.Linear(hidden_nf, hidden_nf)
        self.node_mlp_0 = nn.Linear(in_nf + hidden_nf, hidden_nf)
        self.node_mlp_1 = nn.Linear(hidden_nf, in_nf)

    def forward(self, h: torch.Tensor, nbr_idx: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h_row, h_nbr = _rows(h, nbr_idx)
        m = self.edge_mlp_1(self.act(self.edge_mlp_0(torch.cat([h_row, h_nbr], -1))))
        out = self.act(self.node_mlp_0(torch.cat([h, kregular_sum(m, edge_mask)], -1)))
        return h + self.node_mlp_1(out)


class GCLrf(nn.Module):
    """The radial-field layer: a coordinate-only update x += Σ rel·φ(‖rel‖²)."""

    def __init__(self, hidden_nf: int = 32, act: Callable = F.silu):
        super().__init__()
        self.act = act
        self.phi_0 = nn.Linear(1, hidden_nf)
        self.phi_1 = nn.Linear(hidden_nf, 1, bias=False)

    def forward(self, x: torch.Tensor, nbr_idx: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        geom = edge_geometry(x, nbr_idx, so3_mode="invariant")
        s = self.phi_1(self.act(self.phi_0(geom.radial)))
        return x + kregular_sum(geom.rel * s, edge_mask)


def coord2localframe(x: torch.Tensor, nbr_idx: torch.Tensor,
                     degen_threshold: float = 1e-3) -> torch.Tensor:
    """ClofNet's scalarization frame per edge: a = normalize(x_i − x_j),
    b = normalize(x_i × x_j), c = a × b → [B, N, K, 3, 3] (rows a, b, c).

    Near-parallel positions make normalize(x_i × x_j) ill-conditioned (the
    direction of a ~0 cross product flips under rounding), so a frame with
    ‖x_i × x_j‖ < degen_threshold·‖x_i‖‖x_j‖, or ‖x_i − x_j‖ < 1e-6, is
    zeroed and contributes nothing."""
    x_row, x_nbr = _rows(x, nbr_idx)
    rel = x_row - x_nbr
    cross = torch.linalg.cross(x_row, x_nbr, dim=-1)
    scale = safe_norm(x_row, keepdim=True) * safe_norm(x_nbr, keepdim=True)
    degen = ((safe_norm(cross, keepdim=True) < degen_threshold * scale)
             | (safe_norm(rel, keepdim=True) < 1e-6))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    b = torch.where(degen, zero, safe_normalize(cross))
    a = torch.where(degen, zero, safe_normalize(rel))
    c = torch.linalg.cross(a, b, dim=-1)
    return torch.stack([a, b, c], dim=-2)


class ClofGCL(nn.Module):
    """ClofNet's local-frame layer: invariant edge features from projections
    on the edge frame; the coordinate update a learned combination of the
    frame's 3 basis vectors. h [B, N, in_nf]."""

    def __init__(self, in_nf: int, hidden_nf: int = 32, act: Callable = F.silu):
        super().__init__()
        self.act = act
        self.edge_mlp_0 = nn.Linear(2 * in_nf + 4, hidden_nf)
        self.edge_mlp_1 = nn.Linear(hidden_nf, hidden_nf)
        self.coord_coefs = nn.Linear(hidden_nf, 3, bias=False)
        self.node_mlp_0 = nn.Linear(in_nf + hidden_nf, hidden_nf)
        self.node_mlp_1 = nn.Linear(hidden_nf, in_nf)

    def forward(self, h: torch.Tensor, x: torch.Tensor, nbr_idx: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
        frame = coord2localframe(x, nbr_idx)                  # [B, N, K, 3, 3]
        rel = x[..., :, None, :] - gather_neighbors(x, nbr_idx)
        proj = torch.einsum("...kij,...kj->...ki", frame, rel)
        radial = torch.sum(rel * rel, dim=-1, keepdim=True)
        h_row, h_nbr = _rows(h, nbr_idx)
        m = self.act(self.edge_mlp_0(torch.cat([h_row, h_nbr, radial, proj], -1)))
        m = self.edge_mlp_1(m)
        delta = torch.einsum("...kij,...ki->...kj", frame, self.coord_coefs(m))
        x = x + kregular_sum(delta, edge_mask)
        out = self.act(self.node_mlp_0(torch.cat([h, kregular_sum(m, edge_mask)], -1)))
        return h + self.node_mlp_1(out), x


def build_gaussian_adjacency(x: torch.Tensor, sigma: float = 1.0,
                             threshold: float = 0.0) -> torch.Tensor:
    """The dense symmetric-normalized Gaussian adjacency
    Â = D^-1/2 A D^-1/2 with A = exp(−‖x_i − x_j‖²/2σ²) (entries at or
    below `threshold` dropped when it is positive), x [B, N, 3] →
    [B, N, N]: the legacy GCN's k-d tree and sparse pipeline as one dense
    expression."""
    d2 = torch.sum((x[..., :, None, :] - x[..., None, :, :]) ** 2, dim=-1)
    A = torch.exp(-d2 / (2.0 * sigma ** 2))
    if threshold > 0:
        A = torch.where(A > threshold, A, torch.zeros_like(A))
    dinv = torch.rsqrt(torch.clamp(torch.sum(A, dim=-1), min=1e-12))
    return A * dinv[..., :, None] * dinv[..., None, :]


class GraphConvolution(nn.Module):
    """The dense-adjacency GCN layer: h' = act(Â h W)."""

    def __init__(self, in_features: int, out_features: int, act: Callable = F.relu):
        super().__init__()
        self.act = act
        self.weight = nn.Linear(in_features, out_features)

    def forward(self, h: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        return self.act(torch.einsum("...nm,...mc->...nc", adj, self.weight(h)))


class GlobalPooling(nn.Module):
    """Max and mean pooling over the point axis, concatenated."""

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.amax(h, dim=-2), torch.mean(h, dim=-2)], dim=-1)


class EGCLVel(nn.Module):
    """The EGCL with a velocity channel: v' = φ_v(h)·v + Σ rel·φ_x(m);
    x' = x + v'. h [B, N, in_nf]."""

    def __init__(self, in_nf: int, hidden_nf: int = 32, act: Callable = F.silu):
        super().__init__()
        self.act = act
        self.edge_mlp_0 = nn.Linear(2 * in_nf + 1, hidden_nf)
        self.edge_mlp_1 = nn.Linear(hidden_nf, hidden_nf)
        self.coord_mlp_0 = nn.Linear(hidden_nf, hidden_nf)
        self.coord_mlp_out = nn.Linear(hidden_nf, 1, bias=False)
        self.vel_mlp_0 = nn.Linear(in_nf, hidden_nf)
        self.vel_mlp_1 = nn.Linear(hidden_nf, 1)
        self.node_mlp_0 = nn.Linear(in_nf + hidden_nf, hidden_nf)
        self.node_mlp_1 = nn.Linear(hidden_nf, in_nf)

    def forward(self, h: torch.Tensor, x: torch.Tensor, v: torch.Tensor, nbr_idx: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        geom = edge_geometry(x, nbr_idx, so3_mode="invariant")
        h_row, h_nbr = _rows(h, nbr_idx)
        m = self.act(self.edge_mlp_0(torch.cat([h_row, h_nbr, geom.radial], -1)))
        m = self.edge_mlp_1(m)
        scale = self.coord_mlp_out(self.act(self.coord_mlp_0(m)))
        force = kregular_sum(geom.rel * scale, edge_mask)
        v = self.vel_mlp_1(self.act(self.vel_mlp_0(h))) * v + force
        x = x + v
        out = self.act(self.node_mlp_0(torch.cat([h, kregular_sum(m, edge_mask)], -1)))
        return h + self.node_mlp_1(out), x, v
