"""Fused EGCL layer: the CUDA kernels `csrc/egcl_tile.cu` (fast mode at
C=32, on the tensor cores) and `csrc/egcl.cu` (accurate mode and every other
width), and their plain version (counterpart of
`ops/pallas/egcl_kernel.py`), forward, 'center' direction, 'frame' so3 mode,
all-ones edge_attr, no edge mask. `egcl_variant` picks the kernel from the
shape and the mode before the launch. The backward is `egcl_backward.py`;
`egnn_forward` routes each layer through its `EGCLFunction` whenever
autograd needs a gradient.

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


def live_params(layer: EGCL) -> EGCLParams:
    """Arrange one EGCL module's weights for the kernel (the counterpart of
    the reference's `params_from_tree`), from the live parameters. When
    autograd records, the folds carry gradients back: db1 reaches both
    `fused_in.bias` and the edge_attr column of `fused_in.weight`, dw2 the
    diagonal blocks of `head_kernels`. Under `torch.no_grad()` nothing is
    recorded."""
    em = layer.edge_mlp
    w1 = em.fused_in.weight                             # [C, 2C+13]
    c = w1.shape[0]
    hk = em.head_kernels                                # [H, w, w] (in, out)
    return EGCLParams(
        w1_hrow=w1[:, :c], w1_hcol=w1[:, c:2 * c], w1_geo=w1[:, 2 * c:2 * c + 12],
        b1=em.fused_in.bias + w1[:, 2 * c + 12],
        w2=torch.block_diag(*hk.unbind(0)).T,
        b2=em.head_biases.reshape(-1),
        ln_scale=layer.layer_norm.weight, ln_bias=layer.layer_norm.bias,
        wc0=layer.coord_mlp_0.weight, bc0=layer.coord_mlp_0.bias,
        wc1=layer.coord_mlp_out.weight,
        wn0=layer.node_mlp_0.weight, bn0=layer.node_mlp_0.bias,
        wn1=layer.node_mlp_1.weight, bn1=layer.node_mlp_1.bias,
        head_width=hk.shape[-1])


def params_from_layer(layer: EGCL) -> EGCLParams:
    """`live_params`, detached: the layout for calling the kernel (or its
    plain version) directly."""
    p = live_params(layer)
    return EGCLParams(*(t.detach() for t in p[:-1]), p.head_width)


def pack_params(p: EGCLParams) -> torch.Tensor:
    """The flat fp32 buffer `csrc/egcl.cu` reads (struct Offsets): every
    matrix transposed to [in][out], in the order of EGCLParams."""
    parts = [p.w1_hrow.T, p.w1_hcol.T, p.w1_geo.T, p.b1, p.w2.T, p.b2,
             p.ln_scale, p.ln_bias, p.wc0.T, p.bc0, p.wc1.T, p.wn0.T, p.bn0,
             p.wn1.T, p.bn1]
    return torch.cat([t.detach().reshape(-1) for t in parts]).to(torch.float32).contiguous()


TILE_C = 32                    # the tile kernel's width (csrc/egcl_tile.cuh)
# the B-fragment matrices, then the fp32 vectors [32], in the order of
# `Layout` in csrc/egcl_tile.cuh
TILE_MATRICES = ("w1", "w2", "wc0", "wn0", "wn1")
TILE_VECTORS = ("b1", "b2", "ln_scale", "ln_bias", "bc0", "wc1", "bn0", "bn1")


class Packed(NamedTuple):
    """One layer's kernel buffers: `simt` for `csrc/egcl.cu` and
    `csrc/egcl_backward.cu` (`pack_params`), `tile` for `csrc/egcl_tile.cu`
    (`pack_params_tile`; None where the layer's shape has no tile kernel)."""
    simt: torch.Tensor
    tile: torch.Tensor | None


def egcl_variant(c: int, k: int, head_width: int, accurate: bool) -> str:
    """Which hand-written kernel runs a layer of width `c`, `k` neighbors and
    heads of `head_width` channels: 'tile' (`csrc/egcl_tile.cu`, bf16
    mma.sync) for fast mode at C=32 with a head width that divides 32,
    'simt' (`csrc/egcl.cu`) for accurate mode and every other shape. A choice
    by shape, made before the launch; a launch that fails raises."""
    if not accurate and c == TILE_C and k >= 1 and head_width >= 1 and TILE_C % head_width == 0:
        return "tile"
    return "simt"


def b_fragments(w: torch.Tensor) -> torch.Tensor:
    """A weight [32, in] (in a multiple of 16) → the bf16 B fragments of
    `mma.m16n8k16` for activations @ w.T, flat: block (k-step j, n-tile n),
    then lane = 4g + t, then (b0.lo, b0.hi, b1.lo, b1.hi) = B[16j + 2t + {0,
    1, 8, 9}][8n + g] with B = w.T."""
    bm = w.detach().to(torch.float32).T.to(torch.bfloat16)          # [in, 32]
    f = bm.reshape(bm.shape[0] // 16, 2, 4, 2, 4, 8)                # j, half, t, lo, n, g
    return f.permute(0, 4, 5, 2, 1, 3).reshape(-1)                  # j, n, g, t, half, lo


def pack_params_tile(p: EGCLParams) -> torch.Tensor:
    """The buffer `csrc/egcl_tile.cu` reads (`Layout` in egcl_tile.cuh), as
    float32 words: first the matrices as bf16 B fragments, two to a word —
    w1 = [w1_hcol | w1_geo | 4 zero columns | w1_hrow] (80 inputs), the dense
    block-diagonal w2, wc0, wn0, wn1 — then fp32 b1, b2, ln_scale, ln_bias,
    bc0, wc1 (rounded to bf16: it is a product's operand), bn0, bn1."""
    c = p.b1.shape[0]
    if c != TILE_C or TILE_C % p.head_width:
        raise ValueError(f"the tile kernel takes C={TILE_C} with whole heads, got C={c}, "
                         f"head width {p.head_width}")
    f32 = lambda t: t.detach().to(torch.float32)
    w1 = torch.cat([f32(p.w1_hcol), f32(p.w1_geo), torch.zeros_like(f32(p.w1_geo[:, :4])),
                    f32(p.w1_hrow)], dim=1)
    mats = dict(w1=w1, w2=p.w2, wc0=p.wc0, wn0=p.wn0, wn1=p.wn1)
    frags = torch.cat([b_fragments(mats[name]) for name in TILE_MATRICES])
    vecs = dict(b1=p.b1, b2=p.b2, ln_scale=p.ln_scale, ln_bias=p.ln_bias, bc0=p.bc0,
                wc1=_round(True)(f32(p.wc1)), bn0=p.bn0, bn1=p.bn1)
    return torch.cat([frags.contiguous().view(torch.float32),
                      *(f32(vecs[name]).reshape(-1) for name in TILE_VECTORS)]).contiguous()


def pack_for_kernels(p: EGCLParams) -> Packed:
    """Both kernel buffers of a layer, on the parameters' device."""
    has_tile = egcl_variant(p.b1.shape[0], 1, p.head_width, accurate=False) == "tile"
    return Packed(pack_params(p), pack_params_tile(p) if has_tile else None)


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


def edge_stages_plain(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                      p: EGCLParams, accurate: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The edge program per edge: (rel [B,N,K,3]; s1 [B,N,K,C], the first
    edge layer after its SiLU; m [B,N,K,C], the message after LayerNorm;
    s [B,N,K,1], the coordinate scalar)."""
    r = _round(not accurate)
    mm = lambda a, w: torch.matmul(r(a), r(w).T)
    b, n, k = nbr.shape
    flat = nbr.reshape(b, n * k).long()[..., None]
    x_col = torch.take_along_dim(x, flat, dim=1).reshape(b, n, k, 3)
    h_col = torch.take_along_dim(h, flat, dim=1).reshape(b, n, k, -1)
    rel, geo = edge_features(x[:, :, None, :], x_col)
    m = (mm(h, p.w1_hrow)[:, :, None, :] + mm(h_col, p.w1_hcol)) + mm(geo, p.w1_geo)
    s1 = F.silu(m + p.b1)
    m = mm(s1, p.w2) + p.b2
    mu = torch.mean(m, dim=-1, keepdim=True)
    var = torch.mean((m - mu) ** 2, dim=-1, keepdim=True)
    m = (m - mu) * torch.rsqrt(var + 1e-5) * p.ln_scale + p.ln_bias
    s = mm(F.silu(mm(m, p.wc0) + p.bc0), p.wc1)
    return rel, s1, m, s


def edge_aggregates_plain(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                          p: EGCLParams, accurate: bool = True
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The edge program summed onto centers: (agg_m [B,N,C], the message
    sum before the node MLP; agg_x [B,N,3] = Σ_k rel·s, the coordinate
    update)."""
    rel, _, m, s = edge_stages_plain(h, x, nbr, p, accurate)
    return torch.sum(m, dim=2), torch.sum(rel * s, dim=2)


def node_forward(h: torch.Tensor, agg_m: torch.Tensor, p: EGCLParams,
                 accurate: bool = True) -> torch.Tensor:
    """The node MLP and residual: h + wn1·silu(wn0·[h, agg_m] + bn0) + bn1."""
    r = _round(not accurate)
    mm = lambda a, w: torch.matmul(r(a), r(w).T)
    out = F.silu(mm(torch.cat([h, agg_m], dim=-1), p.wn0) + p.bn0)
    return h + (mm(out, p.wn1) + p.bn1)


def egcl_layer_plain(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                     p: EGCLParams, accurate: bool = True,
                     return_aggm: bool = False) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel: h [B,N,C], x [B,N,3],
    nbr [B,N,K] → (h', x'), and agg_m when asked."""
    agg_m, agg_x = edge_aggregates_plain(h, x, nbr, p, accurate)
    out = (node_forward(h, agg_m, p, accurate), x + agg_x)
    return out + (agg_m,) if return_aggm else out


def check_inputs(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                 head_width: int) -> None:
    """Raise on what the EGCL kernels do not take: contiguous f32 h [B,N,C]
    with 1 <= C <= 64 in whole heads, f32 x [B,N,3], int32 nbr [B,N,K],
    all on h's CUDA device."""
    b, n, c = h.shape
    k = nbr.shape[-1]
    for name, t, shape, dtype in (("h", h, (b, n, c), torch.float32),
                                  ("x", x, (b, n, 3), torch.float32),
                                  ("nbr", nbr, (b, n, k), torch.int32)):
        if (t.device != h.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} {shape} on "
                             f"{h.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= c <= 64 or c % head_width:
        raise ValueError(f"the kernel takes 1 <= C <= 64 with whole heads, got C={c}")


def _launch_tile(h, x, nbr, p, tile, agg_m, dbg):
    """Launch `csrc/egcl_tile.cu` → (h', x'); fills agg_m and dbg if given."""
    b, n, _ = h.shape
    h_out, x_out = torch.empty_like(h), torch.empty_like(x)
    fn = build.load("egcl_tile").egcl_tile_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(h.data_ptr(), x.data_ptr(), nbr.data_ptr(), tile.data_ptr(),
                 h_out.data_ptr(), x_out.data_ptr(), ptr(agg_m), ptr(dbg), b, n,
                 nbr.shape[-1], p.head_width, stream)
    build.check(err, "egcl_tile_launch")
    return h_out, x_out


def _launch_simt(h, x, nbr, p, simt, agg_m, accurate):
    """Launch `csrc/egcl.cu` → (h', x'); fills agg_m if given."""
    b, n, c = h.shape
    h_out, x_out = torch.empty_like(h), torch.empty_like(x)
    fn = build.load("egcl").egcl_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(h.data_ptr(), x.data_ptr(), nbr.data_ptr(), simt.data_ptr(),
                 h_out.data_ptr(), x_out.data_ptr(),
                 None if agg_m is None else agg_m.data_ptr(), b, n, nbr.shape[-1], c,
                 p.head_width, int(not accurate), stream)
    build.check(err, "egcl_launch")
    return h_out, x_out


def egcl_layer(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
               p: EGCLParams, accurate: bool = True,
               packed: Packed | None = None, return_aggm: bool = False,
               variant: str | None = None) -> tuple[torch.Tensor, ...]:
    """One fused EGCL layer → (h', x'), and agg_m [B,N,C] (the message sum
    before the node MLP, which the backward needs) when asked. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel that
    `egcl_variant` names for its shape and mode. `packed` is
    `pack_for_kernels(p)` when the caller already has it on the device.
    `variant='simt'` asks for `csrc/egcl.cu` where the tile kernel would run
    (to compare the two); 'tile' where the shape has no tile kernel raises.
    Every nbr index must lie in [0, N)."""
    if h.device.type == "cpu":
        return egcl_layer_plain(h, x, nbr, p, accurate, return_aggm)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    check_inputs(h, x, nbr, p.head_width)
    by_shape = egcl_variant(h.shape[-1], nbr.shape[-1], p.head_width, accurate)
    variant = by_shape if variant is None else variant
    if variant not in ("tile", "simt") or (variant == "tile" and by_shape != "tile"):
        raise ValueError(f"no {variant!r} EGCL kernel for C={h.shape[-1]}, "
                         f"head width {p.head_width}, accurate={accurate}")
    agg_m = torch.empty_like(h) if return_aggm else None
    if variant == "tile":
        tile = pack_params_tile(p).to(h.device) if packed is None else packed.tile
        h_out, x_out = _launch_tile(h, x, nbr, p, tile, agg_m, None)
    else:
        simt = pack_params(p).to(h.device) if packed is None else packed.simt
        h_out, x_out = _launch_simt(h, x, nbr, p, simt, agg_m, accurate)
    egcl_layer.launches += 1
    egcl_layer.launches_by_variant[variant] += 1
    return (h_out, x_out, agg_m) if return_aggm else (h_out, x_out)


egcl_layer.launches = 0
egcl_layer.launches_by_variant = {"tile": 0, "simt": 0}


def egcl_tile_stages(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                     p: EGCLParams) -> tuple[torch.Tensor, torch.Tensor]:
    """The tile kernel's per-edge stages on the card, (s1, m) as
    `edge_stages_plain` names them, each [B,N,K,32]: a check of the fragment
    layouts stage by stage. Not a path of the layer and not counted."""
    check_inputs(h, x, nbr, p.head_width)
    if h.device.type != "cuda" or egcl_variant(h.shape[-1], nbr.shape[-1], p.head_width,
                                               False) != "tile":
        raise ValueError("the tile kernel takes CUDA tensors at C=32 with whole heads")
    dbg = torch.zeros(*nbr.shape, 2 * TILE_C, dtype=torch.float32, device=h.device)
    _launch_tile(h, x, nbr, p, pack_params_tile(p).to(h.device), None, dbg)
    return dbg[..., :TILE_C], dbg[..., TILE_C:]


def mma_tile_probe(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One bare `mma.m16n8k16` tile on the card: a [16,16] bf16 times the
    first 8 output channels of w [32,16] through `b_fragments` → a @ w[:8].T
    [16,8] f32. Holds the fragment layouts and the host's packing against a
    matrix product."""
    if a.device.type != "cuda" or a.dtype != torch.bfloat16 or tuple(a.shape) != (16, 16):
        raise ValueError("a must be a CUDA bf16 [16,16] tensor")
    a = a.contiguous()
    block = b_fragments(w)[:128].contiguous().view(torch.float32).to(a.device)
    d = torch.empty(16, 8, dtype=torch.float32, device=a.device)
    fn = build.load("egcl_tile").egcl_tile_mma_probe
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), block.data_ptr(), d.data_ptr(),
                 torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "egcl_tile_mma_probe")
    return d


class KernelEGNN(NamedTuple):
    """An EGNN's weights arranged for `egnn_forward`."""
    egnn: EGNN
    layers: list          # [EGCLParams]
    packed: list          # [Packed, on the module's device]


def kernel_params(egnn: EGNN) -> KernelEGNN:
    """The layout of every layer, from the live parameters (`live_params`).
    Serving builds it once under `torch.no_grad()`; training builds it on
    every step with autograd on, so gradients flow back through the folds."""
    layers = [live_params(layer) for layer in egnn.layers()]
    return KernelEGNN(egnn, layers, [pack_for_kernels(p) for p in layers])


def egnn_forward(kp: KernelEGNN, h: torch.Tensor, x: torch.Tensor,
                 nbr: torch.Tensor, accurate: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Embedding → n × fused EGCL → embedding; h [B,N,C_in], x [B,N,3].
    The embeddings are plain matmuls (in fast mode on bf16-rounded operands,
    as the TPU's DEFAULT precision gives). When autograd needs a gradient
    (of h, x or a layer weight), each layer runs as `EGCLFunction`: the
    forward kernel with agg_m, the backward kernel behind it."""
    from .egcl_backward import EGCLFunction

    r = _round(not accurate)
    emb_in, emb_out = kp.egnn.embedding_in, kp.egnn.embedding_out
    h = torch.matmul(r(h), r(emb_in.weight).T) + emb_in.bias
    x = x.to(torch.float32).contiguous()
    nbr = nbr.to(torch.int32).contiguous()
    for p, packed in zip(kp.layers, kp.packed):
        h = h.contiguous()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (h, x, *p[:-1])):
            h, x = EGCLFunction.apply(h, x, nbr, p.head_width, accurate, packed, *p[:-1])
        else:
            h, x = egcl_layer(h, x, nbr, p, accurate, packed)
    h = torch.matmul(r(h), r(emb_out.weight).T) + emb_out.bias
    return h, x
