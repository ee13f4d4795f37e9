"""Fused EGCL layer: the CUDA kernels `csrc/egcl_tile.cu` (fast mode at
C=32 and at 32 < C <= 36, on the tensor cores), `csrc/egcl_tile_f32.cu`
(accurate mode at the same widths, fp32 register-blocked tiles) and
`csrc/egcl.cu` (every other shape), and
their plain version (counterpart of
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
from typing import TYPE_CHECKING, NamedTuple

import torch
from torch.nn import functional as F

from . import build
from .build import OPS

if TYPE_CHECKING:                 # an exported program's loader imports this module
    from ...models.egnn import EGCL, EGNN

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


def _fp32(t: torch.Tensor) -> torch.Tensor:
    """A parameter in fp32: the cast of a bf16 one, an fp32 one itself."""
    return t.to(torch.float32)


def live_params(layer: EGCL) -> EGCLParams:
    """Arrange one EGCL module's weights for the kernel (the counterpart of
    the reference's `params_from_tree`), from the live parameters. When
    autograd records, the folds carry gradients back: db1 reaches both
    `fused_in.bias` and the edge_attr column of `fused_in.weight`, dw2 the
    diagonal blocks of `head_kernels`. Under `torch.no_grad()` nothing is
    recorded. bf16 parameters fold in fp32 (`params_from_tree(dtype=
    float32)` in the JAX package): each is cast first, and autograd rounds
    their gradients back to bf16 through the casts; fp32 parameters pass
    as they are."""
    em = layer.edge_mlp
    f = _fp32
    w1 = f(em.fused_in.weight)                          # [C, 2C+13]
    c = w1.shape[0]
    hk = f(em.head_kernels)                             # [H, w, w] (in, out)
    return EGCLParams(
        w1_hrow=w1[:, :c], w1_hcol=w1[:, c:2 * c], w1_geo=w1[:, 2 * c:2 * c + 12],
        b1=f(em.fused_in.bias) + w1[:, 2 * c + 12],
        w2=torch.block_diag(*hk.unbind(0)).T,
        b2=f(em.head_biases).reshape(-1),
        ln_scale=f(layer.layer_norm.weight), ln_bias=f(layer.layer_norm.bias),
        wc0=f(layer.coord_mlp_0.weight), bc0=f(layer.coord_mlp_0.bias),
        wc1=f(layer.coord_mlp_out.weight),
        wn0=f(layer.node_mlp_0.weight), bn0=f(layer.node_mlp_0.bias),
        wn1=f(layer.node_mlp_1.weight), bn1=f(layer.node_mlp_1.bias),
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


TILE_C = 32                    # the tile kernels' unpadded width
# the bf16 tile kernels' compiled widths CP (csrc/egcl_tile.cuh): CP=32 runs
# C=32, CP=48 runs 32 < C <= 36 with the channels C..47 as zero pads (a
# width of whole 16-channel k-steps)
TILE_WIDTHS = (32, 48)
# the fp32 tile kernels' compiled widths CP (csrc/egcl_tile_f32.cuh): CP=32
# runs C=32, CP=36 runs 32 < C <= 36 with the channels C..35 as zero pads
F32_WIDTHS = (32, 36)
PADDED_C = 36                  # the widest C the padded builds of both families run


def _compiled_width(c: int, widths: tuple) -> int | None:
    if c == TILE_C:
        return widths[0]
    return widths[1] if TILE_C < c <= PADDED_C else None


def tile_width(c: int) -> int | None:
    """The compiled width of the bf16 tile kernels that runs width `c`:
    32 at C=32, 48 at 32 < C <= 36, else None."""
    return _compiled_width(c, TILE_WIDTHS)


def f32_width(c: int) -> int | None:
    """The compiled width of the fp32 tile kernels that runs width `c`:
    32 at C=32, 36 at 32 < C <= 36, else None."""
    return _compiled_width(c, F32_WIDTHS)


# the B-fragment matrices, then the fp32 vectors [CP], in the order of
# `Layout<CP>` in csrc/egcl_tile.cuh
TILE_MATRICES = ("w1", "w2", "wc0", "wn0", "wn1")
TILE_VECTORS = ("b1", "b2", "ln_scale", "ln_bias", "bc0", "wc1", "bn0", "bn1")


class Packed(NamedTuple):
    """One layer's kernel buffers: `simt` for `csrc/egcl.cu` and
    `csrc/egcl_backward.cu` (`pack_params`); `tile` for `csrc/egcl_tile.cu`
    (`pack_params_tile`) and, with `tile_bwd` (`pack_params_tile_bwd`), for
    `csrc/egcl_backward_tile.cu`; `f32` for `csrc/egcl_tile_f32.cu` and
    `csrc/egcl_backward_tile_f32.cu` (`pack_params_f32`); `tile` and
    `tile_bwd` None where fast mode has no tile kernel for the layer's
    shape, `f32` None where accurate mode has none; each at the width
    (`tile_width`, `f32_width`) that runs the layer's C."""
    simt: torch.Tensor
    tile: torch.Tensor | None
    tile_bwd: torch.Tensor | None
    f32: torch.Tensor | None


VARIANTS = ("tile", "tile_f32", "simt")


def egcl_variant(c: int, k: int, head_width: int, accurate: bool) -> str:
    """Which hand-written kernel runs a layer of width `c`, `k` neighbors and
    heads of `head_width` channels, the heads whole: at C=32 and at
    32 < C <= 36 (KITTI's C=33), 'tile' (`csrc/egcl_tile.cu`, bf16
    mma.sync; padded to 48 channels above 32) in fast mode and 'tile_f32'
    (`csrc/egcl_tile_f32.cu`, fp32 register-blocked tiles; padded to 36
    channels above 32) in accurate mode; 'simt' (`csrc/egcl.cu`) for every
    other shape. A choice by shape, made before the launch; a launch that
    fails raises."""
    if k >= 1 and head_width >= 1 and c % head_width == 0:
        if accurate and f32_width(c) is not None:
            return "tile_f32"
        if not accurate and tile_width(c) is not None:
            return "tile"
    return "simt"


def check_variant(variant: str | None, c: int, k: int, head_width: int,
                  accurate: bool) -> str:
    """The kernel to launch: `variant`, or `egcl_variant`'s choice when it is
    None. 'simt' runs every shape in both modes; a tile variant that is not
    the shape's and mode's raises."""
    by_shape = egcl_variant(c, k, head_width, accurate)
    variant = by_shape if variant is None else variant
    if variant not in VARIANTS or (variant != "simt" and variant != by_shape):
        raise ValueError(f"no {variant!r} EGCL kernel for C={c}, head width {head_width}, "
                         f"accurate={accurate}")
    return variant


def b_fragments(w: torch.Tensor) -> torch.Tensor:
    """A weight [out, in] (out a multiple of 8, in of 16) → the bf16 B
    fragments of `mma.m16n8k16` for activations @ w.T, flat: block (k-step j,
    n-tile n), then lane = 4g + t, then (b0.lo, b0.hi, b1.lo, b1.hi) =
    B[16j + 2t + {0, 1, 8, 9}][8n + g] with B = w.T."""
    bm = w.detach().to(torch.float32).T.to(torch.bfloat16)          # [in, out]
    f = bm.reshape(bm.shape[0] // 16, 2, 4, 2, bm.shape[1] // 8, 8)  # j, half, t, lo, n, g
    return f.permute(0, 4, 5, 2, 1, 3).reshape(-1)                  # j, n, g, t, half, lo


def _tile_cp(p: EGCLParams) -> int:
    """The bf16 tile width that runs the layer `p`; raises where none does."""
    c = p.b1.shape[0]
    cp = tile_width(c)
    if cp is None or c % p.head_width:
        raise ValueError(f"the bf16 tile kernels take C=32 or 32 < C <= {PADDED_C} with whole "
                         f"heads, got C={c}, head width {p.head_width}")
    return cp


def pack_params_tile(p: EGCLParams) -> torch.Tensor:
    """The buffer `csrc/egcl_tile.cu` reads (`Layout<CP>` in egcl_tile.cuh)
    at the compiled width CP = `tile_width(C)`, as float32 words: first the
    matrices as bf16 B fragments, two to a word — w1 = [w1_hcol | w1_geo |
    4 zero columns | w1_hrow] (2 CP + 16 inputs), the dense block-diagonal
    w2, wc0, wn0 ([h | agg_m], CP inputs each), wn1 — then fp32 b1, b2,
    ln_scale, ln_bias, bc0, wc1 (rounded to bf16: it is a product's
    operand), bn0, bn1. Each holds the layer's weights in its leading
    corner and zeros in the rows and columns of the pad channels C..CP-1."""
    cp = _tile_cp(p)
    f32 = lambda t: t.detach().to(torch.float32)
    sq = lambda t: _pad(f32(t), (cp, cp))
    w1 = torch.cat([sq(p.w1_hcol), _pad(f32(p.w1_geo), (cp, 16)), sq(p.w1_hrow)], dim=1)
    c = p.b1.shape[0]
    wn0 = f32(p.wn0)                                          # [C, 2C]: h, agg_m
    mats = dict(w1=w1, w2=sq(p.w2), wc0=sq(p.wc0), wn0=torch.cat([sq(wn0[:, :c]),
                                                                sq(wn0[:, c:])], dim=1),
                wn1=sq(p.wn1))
    frags = torch.cat([b_fragments(mats[name]) for name in TILE_MATRICES])
    vecs = dict(b1=p.b1, b2=p.b2, ln_scale=p.ln_scale, ln_bias=p.ln_bias, bc0=p.bc0,
                wc1=_round(True)(f32(p.wc1)), bn0=p.bn0, bn1=p.bn1)
    return torch.cat([frags.contiguous().view(torch.float32),
                      *(_pad(f32(vecs[name]).reshape(-1), (cp,)) for name in TILE_VECTORS)]
                     ).contiguous()


# the backward's B-fragment matrices, in the order of `BwdLayout<CP>` in
# csrc/egcl_backward_tile.cu (CP/8, CP/8, CP/4 and 2 n-tiles): each is the
# weight a cotangent is multiplied by on its way back, B = the weight itself
TILE_BWD_MATRICES = ("wc0", "w2", "w1_h", "w1_geo")


def pack_params_tile_bwd(p: EGCLParams) -> torch.Tensor:
    """The backward's own buffer for `csrc/egcl_backward_tile.cu`, carried in
    `Packed.tile_bwd` beside `pack_params_tile` (which the backward kernel
    reads too, for the recomputed forward): the transposed products
    cotangent @ W as bf16 B fragments, `b_fragments(W.T)`, two to a word —
    Wc0 (dm from dcm_in), the dense block-diagonal w2 (ds1 from dv),
    [W1hc | W1hr] (dh_col and dh_row from du, CP/4 n-tiles) and W1g (dgeo
    from du) padded from 12 to 16 outputs with zero rows (2 n-tiles); at the
    compiled width CP = `tile_width(C)`, zeros in the pad channels C..CP-1."""
    cp = _tile_cp(p)
    f32 = lambda t: t.detach().to(torch.float32)
    sq = lambda t: _pad(f32(t).T, (cp, cp))
    mats = dict(wc0=sq(p.wc0), w2=sq(p.w2), w1_h=torch.cat([sq(p.w1_hcol), sq(p.w1_hrow)]),
                w1_geo=_pad(f32(p.w1_geo).T, (16, cp)))
    frags = torch.cat([b_fragments(mats[name]) for name in TILE_BWD_MATRICES])
    return frags.contiguous().view(torch.float32)


def f32_layout(cp: int) -> tuple:
    """`Layout<CP>` in csrc/egcl_tile_f32.cuh: (name, [rows][row length] as
    stored) at the compiled width `cp`. Matrices are [in][out] (the kernel
    computes activations @ matrix); the backward's `*_t` are the torch
    [out][in] weights a cotangent goes back through; w1 = [w1_hcol.T;
    w1_geo.T] and w1g_t = w1_geo padded to 16 inputs; wn0 = [h | agg_m]
    inputs, cp rows each."""
    return (("w1", (cp + 12, cp)), ("w1hr", (cp, cp)), ("w2", (cp, cp)), ("wc0", (cp, cp)),
            ("b1", (cp,)), ("b2", (cp,)), ("ln_scale", (cp,)), ("ln_bias", (cp,)),
            ("bc0", (cp,)), ("wc1", (cp,)),
            ("wc0_t", (cp, cp)), ("w2_t", (cp, cp)), ("w1hc_t", (cp, cp)),
            ("w1hr_t", (cp, cp)), ("w1g_t", (cp, 16)),
            ("wn0", (2 * cp, cp)), ("wn1", (cp, cp)), ("bn0", (cp,)), ("bn1", (cp,)))


F32_LAYOUT = f32_layout(TILE_C)


def _pad(t: torch.Tensor, shape: tuple) -> torch.Tensor:
    """t in the leading corner of a zero tensor of `shape`."""
    widths = [w for n, m in zip(reversed(t.shape), reversed(shape)) for w in (0, m - n)]
    return F.pad(t, widths)


def pack_params_f32(p: EGCLParams) -> torch.Tensor:
    """The fp32 buffer `csrc/egcl_tile_f32.cu` and
    `csrc/egcl_backward_tile_f32.cu` read (`f32_layout`, `Layout<CP>` in
    egcl_tile_f32.cuh) at the compiled width CP = `f32_width(C)`: every row
    CP (w1g_t 16) consecutive fp32 words, so that a row group's float4 loads
    of a weight row hit 32 distinct banks; each block holds the layer's
    weights in its leading corner and zeros in the pad rows and columns of
    the channels C..CP-1 (in w1 and wn0, the h_col and the agg_m inputs
    each start a block of CP rows); no rounding."""
    c = p.b1.shape[0]
    cp = f32_width(c)
    if cp is None or c % p.head_width:
        raise ValueError(f"the fp32 tile kernels take C=32 or 32 < C <= {F32_WIDTHS[-1]} with "
                         f"whole heads, got C={c}, head width {p.head_width}")
    f32 = lambda t: t.detach().to(torch.float32)
    sq = lambda t: _pad(f32(t), (cp, cp))
    v = lambda t: _pad(f32(t).reshape(-1), (cp,))
    wn0 = f32(p.wn0).T                                       # [2C, C]: h, agg_m
    parts = dict(
        w1=torch.cat([sq(f32(p.w1_hcol).T), _pad(f32(p.w1_geo).T, (12, cp))]),
        w1hr=sq(f32(p.w1_hrow).T), w2=sq(f32(p.w2).T), wc0=sq(f32(p.wc0).T), b1=v(p.b1),
        b2=v(p.b2), ln_scale=v(p.ln_scale), ln_bias=v(p.ln_bias), bc0=v(p.bc0), wc1=v(p.wc1),
        wc0_t=sq(p.wc0), w2_t=sq(p.w2), w1hc_t=sq(p.w1_hcol), w1hr_t=sq(p.w1_hrow),
        w1g_t=_pad(f32(p.w1_geo), (cp, 16)),
        wn0=torch.cat([sq(wn0[:c]), sq(wn0[c:])]), wn1=sq(f32(p.wn1).T), bn0=v(p.bn0),
        bn1=v(p.bn1))
    return torch.cat([parts[name].reshape(-1) for name, _ in f32_layout(cp)]).contiguous()


def unpack_params_f32(buf: torch.Tensor, head_width: int, c: int = TILE_C) -> EGCLParams:
    """`pack_params_f32`'s inverse at the true width `c`, from the
    forward's [in][out] blocks (their pads dropped)."""
    cp = f32_width(c)
    if cp is None:
        raise ValueError(f"no fp32 tile width runs C={c}")
    parts, o = {}, 0
    for name, shape in f32_layout(cp):
        n = int(torch.Size(shape).numel())
        parts[name] = buf[o:o + n].reshape(shape)
        o += n
    if o != buf.numel():
        raise ValueError(f"an fp32 tile buffer at CP={cp} holds {o} words, got {buf.numel()}")
    sq = lambda name: parts[name][:c, :c].T
    w1, wn0 = parts["w1"], parts["wn0"]
    return EGCLParams(
        w1_hrow=sq("w1hr"), w1_hcol=w1[:c, :c].T, w1_geo=w1[cp:, :c].T,
        b1=parts["b1"][:c], w2=sq("w2"), b2=parts["b2"][:c], ln_scale=parts["ln_scale"][:c],
        ln_bias=parts["ln_bias"][:c], wc0=sq("wc0"), bc0=parts["bc0"][:c],
        wc1=parts["wc1"][:c].reshape(1, -1),
        wn0=torch.cat([wn0[:c, :c], wn0[cp:cp + c, :c]]).T, bn0=parts["bn0"][:c],
        wn1=sq("wn1"), bn1=parts["bn1"][:c], head_width=head_width)


def pack_for_kernels(p: EGCLParams) -> Packed:
    """Every kernel buffer of a layer, on the parameters' device: the SIMT
    kernels' always, the bf16 tile kernels' and the fp32 tile kernels'
    where the layer's shape has them."""
    c, hw = p.b1.shape[0], p.head_width
    bf16 = egcl_variant(c, 1, hw, accurate=False) == "tile"
    f32 = egcl_variant(c, 1, hw, accurate=True) == "tile_f32"
    return Packed(pack_params(p), pack_params_tile(p) if bf16 else None,
                  pack_params_tile_bwd(p) if bf16 else None,
                  pack_params_f32(p) if f32 else None)


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


def _launch_tile(h, x, nbr, head_width, tile, agg_m, dbg):
    """Launch `csrc/egcl_tile.cu` → (h', x'); fills agg_m and dbg if given."""
    b, n, c = h.shape
    h_out, x_out = torch.empty_like(h), torch.empty_like(x)
    fn = build.load("egcl_tile").egcl_tile_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(h.data_ptr(), x.data_ptr(), nbr.data_ptr(), tile.data_ptr(),
                 h_out.data_ptr(), x_out.data_ptr(), ptr(agg_m), ptr(dbg), b, n,
                 nbr.shape[-1], c, head_width, stream)
    build.check(err, "egcl_tile_launch")
    return h_out, x_out


def _launch_tile_f32(h, x, nbr, head_width, f32, agg_m):
    """Launch `csrc/egcl_tile_f32.cu` → (h', x'); fills agg_m if given."""
    b, n, c = h.shape
    h_out, x_out = torch.empty_like(h), torch.empty_like(x)
    fn = build.load("egcl_tile_f32").egcl_tile_f32_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(h.data_ptr(), x.data_ptr(), nbr.data_ptr(), f32.data_ptr(),
                 h_out.data_ptr(), x_out.data_ptr(),
                 None if agg_m is None else agg_m.data_ptr(), b, n, nbr.shape[-1], c,
                 head_width, stream)
    build.check(err, "egcl_tile_f32_launch")
    return h_out, x_out


def _launch_simt(h, x, nbr, head_width, simt, agg_m, accurate):
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
                 head_width, int(not accurate), stream)
    build.check(err, "egcl_launch")
    return h_out, x_out


# variant → (h, x, nbr, the variant's weight buffer, head width, agg_m or None,
# accurate) → (h', x')
LAUNCHERS = {
    "tile": lambda h, x, nbr, buf, hw, agg_m, accurate: _launch_tile(
        h, x, nbr, hw, buf, agg_m, None),
    "tile_f32": lambda h, x, nbr, buf, hw, agg_m, accurate: _launch_tile_f32(
        h, x, nbr, hw, buf, agg_m),
    "simt": lambda h, x, nbr, buf, hw, agg_m, accurate: _launch_simt(
        h, x, nbr, hw, buf, agg_m, accurate),
}


def kernel_buffer(variant: str, p: EGCLParams, packed: Packed | None) -> torch.Tensor:
    """The weight buffer `variant`'s kernel reads: from `packed` when the
    caller keeps it, else packed from `p` (tensor ops only, so it traces)."""
    if variant == "tile":
        return pack_params_tile(p) if packed is None else packed.tile
    if variant == "tile_f32":
        return pack_params_f32(p) if packed is None else packed.f32
    return pack_params(p) if packed is None else packed.simt


def launch_layer(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor, p: EGCLParams,
                 accurate: bool = True, packed: Packed | None = None,
                 return_aggm: bool = False, variant: str | None = None
                 ) -> tuple[torch.Tensor, ...]:
    """The kernel side of `egcl_layer`, whatever the device: checks the
    inputs, picks the variant (`check_variant`) and its weight buffer, and
    calls the custom op `se3gspr_torch::egcl_layer` (`layer_op`)."""
    check_inputs(h, x, nbr, p.head_width)
    variant = check_variant(variant, h.shape[-1], nbr.shape[-1], p.head_width, accurate)
    buf = kernel_buffer(variant, p, packed).to(h.device)
    h_out, x_out, agg_m = layer_op(h, x, nbr, buf, variant, p.head_width, accurate,
                                   return_aggm)
    return (h_out, x_out, agg_m) if return_aggm else (h_out, x_out)


def run_layer(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor, buf: torch.Tensor,
              variant: str, head_width: int, accurate: bool, return_aggm: bool
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA side of `se3gspr_torch::egcl_layer`: allocates agg_m when
    asked (else returns an empty tensor in its place), launches the
    variant's kernel through `LAUNCHERS` and counts the launch (at call
    time, so an exported program counts each of its runs)."""
    agg_m = torch.empty_like(h) if return_aggm else None
    h_out, x_out = LAUNCHERS[variant](h, x, nbr, buf, head_width, agg_m, accurate)
    egcl_layer.launches += 1
    egcl_layer.launches_by_variant[variant] += 1
    return h_out, x_out, h.new_empty(0) if agg_m is None else agg_m


def egcl_layer(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
               p: EGCLParams, accurate: bool = True,
               packed: Packed | None = None, return_aggm: bool = False,
               variant: str | None = None) -> tuple[torch.Tensor, ...]:
    """One fused EGCL layer → (h', x'), and agg_m [B,N,C] (the message sum
    before the node MLP, which the backward needs) when asked. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel that
    `egcl_variant` names for its shape and mode. `packed` is
    `pack_for_kernels(p)` when the caller already has it on the device.
    `variant='simt'` asks for `csrc/egcl.cu` where a tile kernel would run
    (to compare the two); a tile variant that is not the shape's and mode's
    raises. Every nbr index must lie in [0, N)."""
    if h.device.type == "cpu":
        return egcl_layer_plain(h, x, nbr, p, accurate, return_aggm)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    return launch_layer(h, x, nbr, p, accurate, packed, return_aggm, variant)


egcl_layer.launches = 0
egcl_layer.launches_by_variant = dict.fromkeys(VARIANTS, 0)
layer_op = torch.library.custom_op(OPS + "::egcl_layer", run_layer, mutates_args=(),
                                   device_types="cuda")


@layer_op.register_fake
def _(h, x, nbr, buf, variant, head_width, accurate, return_aggm):
    return (torch.empty_like(h), torch.empty_like(x),
            torch.empty_like(h) if return_aggm else h.new_empty(0))


def egcl_tile_stages(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                     p: EGCLParams) -> tuple[torch.Tensor, torch.Tensor]:
    """The tile kernel's per-edge stages on the card, (s1, m) as
    `edge_stages_plain` names them, each [B,N,K,C]: a check of the fragment
    layouts stage by stage. Not a path of the layer and not counted."""
    check_inputs(h, x, nbr, p.head_width)
    c = h.shape[-1]
    if h.device.type != "cuda" or egcl_variant(c, nbr.shape[-1], p.head_width, False) != "tile":
        raise ValueError("the tile kernel takes CUDA tensors at C=32 or 32 < C <= 36 with "
                         "whole heads")
    cp = tile_width(c)
    dbg = torch.zeros(*nbr.shape, 2 * cp, dtype=torch.float32, device=h.device)
    _launch_tile(h, x, nbr, p.head_width, pack_params_tile(p).to(h.device), None, dbg)
    return dbg[..., :c], dbg[..., cp:cp + c]


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

    r, f = _round(not accurate), _fp32        # bf16 parameters compute in fp32
    emb_in, emb_out = kp.egnn.embedding_in, kp.egnn.embedding_out
    h = torch.matmul(r(h), r(f(emb_in.weight)).T) + f(emb_in.bias)
    x = x.to(torch.float32).contiguous()
    nbr = nbr.to(torch.int32).contiguous()
    for p, packed in zip(kp.layers, kp.packed):
        h = h.contiguous()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (h, x, *p[:-1])):
            h, x = EGCLFunction.apply(h, x, nbr, p.head_width, accurate, packed, *p[:-1])
        else:
            h, x = egcl_layer(h, x, nbr, p, accurate, packed)
    h = torch.matmul(r(h), r(f(emb_out.weight)).T) + f(emb_out.bias)
    return h, x
