"""Fused EGCL layer: the CUDA kernel `csrc/egcl.cu` and its plain version
(counterpart of `ops/pallas/egcl_kernel.py`), forward only, 'center'
direction, 'frame' so3 mode, all-ones edge_attr, no edge mask.

Layout is the standard one, h [B, N, C] and x [B, N, 3] (the TPU kernel's
transposed [B, C, N] layout served its lanes; a GPU warp wants channels
contiguous). Two precision modes:

- accurate: fp32 throughout;
- fast (the served config): the operands of every MLP product — weights
  and activations — are rounded to bf16, accumulation stays fp32, as the
  TPU's DEFAULT-precision matmul does. Gathers, geometry, LayerNorm and the
  k-regular sums stay fp32. The plain version rounds in the same places.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.nn import functional as F

from ...models.egnn import EGCL, EGNN
from . import build

_EPS = 1e-8
_DEGEN = 1e-6


class EGCLParams(NamedTuple):
    """One layer's parameters arranged for the kernel; every 'w*' is
    [out, in] (the kernel computes w @ activations)."""
    w1_hrow: torch.Tensor   # [C, C]   edge-MLP first layer, h_row block
    w1_hcol: torch.Tensor   # [C, C]   h_col block
    w1_geo: torch.Tensor    # [C, 12]  radial, dist, dot, so3(9) block
    b1: torch.Tensor        # [C]      bias + folded edge_attr (=1) column
    w2: torch.Tensor        # [C, C]   block-diagonal per-head second layers
    b2: torch.Tensor        # [C]
    ln_scale: torch.Tensor  # [C]
    ln_bias: torch.Tensor   # [C]
    wc0: torch.Tensor       # [C, C]   coord MLP
    bc0: torch.Tensor       # [C]
    wc1: torch.Tensor       # [1, C]   (no bias)
    wn0: torch.Tensor       # [C, 2C]  node MLP
    bn0: torch.Tensor       # [C]
    wn1: torch.Tensor       # [C, C]
    bn1: torch.Tensor       # [C]
    head_width: int         # C / num_heads


def params_from_layer(layer: EGCL) -> EGCLParams:
    """Arrange one EGCL module's weights for the kernel (the counterpart of
    the reference's `params_from_tree`)."""
    em = layer.edge_mlp
    w1 = em.fused_in.weight.detach()                    # [C, 2C+13]
    c = w1.shape[0]
    hk = em.head_kernels.detach()                       # [H, w, w] (in, out)
    return EGCLParams(
        w1_hrow=w1[:, :c], w1_hcol=w1[:, c:2 * c], w1_geo=w1[:, 2 * c:2 * c + 12],
        b1=em.fused_in.bias.detach() + w1[:, 2 * c + 12],
        w2=torch.block_diag(*hk.unbind(0)).T,
        b2=em.head_biases.detach().reshape(-1),
        ln_scale=layer.layer_norm.weight.detach(),
        ln_bias=layer.layer_norm.bias.detach(),
        wc0=layer.coord_mlp_0.weight.detach(), bc0=layer.coord_mlp_0.bias.detach(),
        wc1=layer.coord_mlp_out.weight.detach(),
        wn0=layer.node_mlp_0.weight.detach(), bn0=layer.node_mlp_0.bias.detach(),
        wn1=layer.node_mlp_1.weight.detach(), bn1=layer.node_mlp_1.bias.detach(),
        head_width=hk.shape[-1])


def pack_params(p: EGCLParams) -> torch.Tensor:
    """The flat fp32 buffer `csrc/egcl.cu` reads (struct Offsets): every
    matrix transposed to [in][out], in the order of EGCLParams."""
    parts = [p.w1_hrow.T, p.w1_hcol.T, p.w1_geo.T, p.b1, p.w2.T, p.b2,
             p.ln_scale, p.ln_bias, p.wc0.T, p.bc0, p.wc1.T, p.wn0.T, p.bn0,
             p.wn1.T, p.bn1]
    return torch.cat([t.reshape(-1) for t in parts]).to(torch.float32).contiguous()


def _round(fast: bool):
    return (lambda t: t.to(torch.bfloat16).to(torch.float32)) if fast else (lambda t: t)


def _safe_unit(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-20)
    return v / (n + _EPS), n


def edge_features(x_row: torch.Tensor, x_col: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rel [..., 3], geo [..., 12]) with the kernel's semantics."""
    rel = x_row - x_col
    radial = torch.sum(rel * rel, dim=-1, keepdim=True)
    dist = torch.sqrt(radial + 1e-20)
    dotf = torch.sum(x_row * x_col, dim=-1, keepdim=True)
    a, _ = _safe_unit(rel)
    b, _ = _safe_unit(torch.linalg.cross(x_row.expand_as(x_col), x_col, dim=-1))
    c = torch.linalg.cross(a, b, dim=-1)
    norm = lambda v: torch.sqrt(torch.sum(v * v, dim=-1) + 1e-20)
    degen = (norm(a) < _DEGEN) | (norm(b) < _DEGEN) | (norm(c) < _DEGEN)
    so3 = torch.stack([a, b, c], dim=-1).reshape(rel.shape[:-1] + (9,))
    eye = torch.eye(3, dtype=so3.dtype, device=so3.device).reshape(9)
    so3 = torch.where(degen[..., None], eye, so3)
    return rel, torch.cat([radial, dist, dotf, so3], dim=-1)


def egcl_layer_plain(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                     p: EGCLParams, accurate: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: h [B,N,C], x [B,N,3],
    nbr [B,N,K] → (h', x')."""
    r = _round(not accurate)
    mm = lambda a, w: torch.matmul(r(a), r(w).T)
    b, n, k = nbr.shape
    flat = nbr.reshape(b, n * k).long()[..., None]
    x_col = torch.take_along_dim(x, flat, dim=1).reshape(b, n, k, 3)
    h_col = torch.take_along_dim(h, flat, dim=1).reshape(b, n, k, -1)
    rel, geo = edge_features(x[:, :, None, :], x_col)
    m = (mm(h, p.w1_hrow)[:, :, None, :] + mm(h_col, p.w1_hcol)) + mm(geo, p.w1_geo)
    m = F.silu(m + p.b1)
    m = mm(m, p.w2) + p.b2
    mu = torch.mean(m, dim=-1, keepdim=True)
    var = torch.mean((m - mu) ** 2, dim=-1, keepdim=True)
    m = (m - mu) * torch.rsqrt(var + 1e-5) * p.ln_scale + p.ln_bias
    s = mm(F.silu(mm(m, p.wc0) + p.bc0), p.wc1)              # [B, N, K, 1]
    x_out = x + torch.sum(rel * s, dim=2)
    out = F.silu(mm(torch.cat([h, torch.sum(m, dim=2)], dim=-1), p.wn0) + p.bn0)
    return h + (mm(out, p.wn1) + p.bn1), x_out


def egcl_layer(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
               p: EGCLParams, accurate: bool = True,
               packed: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused EGCL layer. A CPU tensor takes the plain version; a CUDA
    tensor launches `csrc/egcl.cu`. `packed` is `pack_params(p)` when the
    caller already has it on the device. Every nbr index must lie in [0, N)."""
    if h.device.type == "cpu":
        return egcl_layer_plain(h, x, nbr, p, accurate)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    b, n, c = h.shape
    k = nbr.shape[-1]
    for name, t, shape, dtype in (("h", h, (b, n, c), torch.float32),
                                  ("x", x, (b, n, 3), torch.float32),
                                  ("nbr", nbr, (b, n, k), torch.int32)):
        if (t.device != h.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} {shape} on "
                             f"{h.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= c <= 64 or c % p.head_width:
        raise ValueError(f"the kernel takes 1 <= C <= 64 with whole heads, got C={c}")
    if packed is None:
        packed = pack_params(p).to(h.device)
    h_out, x_out = torch.empty_like(h), torch.empty_like(x)
    fn = build.load("egcl").egcl_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(h.data_ptr(), x.data_ptr(), nbr.data_ptr(), packed.data_ptr(),
                 h_out.data_ptr(), x_out.data_ptr(), b, n, k, c, p.head_width,
                 int(not accurate), stream)
    build.check(err, "egcl_launch")
    egcl_layer.launches += 1
    return h_out, x_out


egcl_layer.launches = 0


class KernelEGNN(NamedTuple):
    """An EGNN's weights arranged once for `egnn_forward`."""
    egnn: EGNN
    layers: list          # [EGCLParams]
    packed: list          # [flat buffer on the module's device]


def kernel_params(egnn: EGNN) -> KernelEGNN:
    layers = [params_from_layer(layer) for layer in egnn.layers()]
    return KernelEGNN(egnn, layers, [pack_params(p) for p in layers])


def egnn_forward(kp: KernelEGNN, h: torch.Tensor, x: torch.Tensor,
                 nbr: torch.Tensor, accurate: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Embedding → n × fused EGCL → embedding; h [B,N,C_in], x [B,N,3].
    The embeddings are plain matmuls (in fast mode on bf16-rounded operands,
    as the TPU's DEFAULT precision gives)."""
    r = _round(not accurate)
    emb_in, emb_out = kp.egnn.embedding_in, kp.egnn.embedding_out
    h = torch.matmul(r(h), r(emb_in.weight).T) + emb_in.bias
    x = x.to(torch.float32).contiguous()
    nbr = nbr.to(torch.int32).contiguous()
    for p, packed in zip(kp.layers, kp.packed):
        h, x = egcl_layer(h.contiguous(), x, nbr, p, accurate, packed)
    h = torch.matmul(r(h), r(emb_out.weight).T) + emb_out.bias
    return h, x
