"""Backward of the fused EGCL layer: the CUDA kernels
`csrc/egcl_backward_tile.cu` (fast mode at C=32 and at 32 < C <= 36, on the
tensor cores), `csrc/egcl_backward_tile_f32.cu` (accurate mode at the same
widths, fp32 register-blocked tiles) and `csrc/egcl_backward.cu` (every
other shape),
their plain version, and `EGCLFunction`, the layer as a differentiable
function (counterpart of `ops/pallas/egcl_backward.py`: `egcl_backward_pallas`
and the custom VJP `egcl_fused_diff`).

The edge program's backward recomputes each edge's forward intermediates
and runs the chain rule back to dh, dx and the gradients of the 11 edge and
coord parameters; the node MLP's backward is dense per-node work and runs
in autograd. Layout and precision modes are those of `egcl.py`: h [B,N,C],
x [B,N,3]; fast rounds the operands of every product (weights, activations
and cotangents) to bf16 and sums in fp32.

The gradient of w2 is returned on its diagonal head blocks only: the other
entries are structural zeros of the block-diagonal layout that no parameter
feeds.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch
from torch.nn import functional as F

from . import build, egcl
from .egcl import EGCLParams

EDGE_PARAMS = ("w1_hrow", "w1_hcol", "w1_geo", "b1", "w2", "b2", "ln_scale",
               "ln_bias", "wc0", "bc0", "wc1")
_NODE_PARAMS = ("wn0", "bn0", "wn1", "bn1")


def _dsilu(u: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(u)
    return s * (1.0 + u * (1.0 - s))


def _normalize_bwd(r, n, inv, da):
    """Backward of a = r·inv, inv = 1/(n + 1e-8), n = sqrt(Σr² + 1e-20)."""
    return da * inv - (inv * inv / n) * torch.sum(da * r, -1, keepdim=True) * r


def head_block_mask(c: int, head_width: int, device=None) -> torch.Tensor:
    """[C, C] bool: True on the diagonal head blocks of w2."""
    heads = torch.arange(c, device=device) // head_width
    return heads[:, None] == heads[None, :]


def _edge_chain(h, x, nbr, p, dagg_m, dagg_x, accurate):
    """The forward recompute and the backward down to du, per edge, on
    [B,N,K,·] tensors: a namespace of every intermediate."""
    r = egcl._round(not accurate)
    mm = lambda a, w: torch.matmul(r(a), r(w).T)      # a · wᵀ, w [out, in]
    mmT = lambda a, w: torch.matmul(r(a), r(w))       # a · w: back through w
    b, n, k = nbr.shape
    c = h.shape[-1]
    flat = nbr.reshape(b, n * k).long()[..., None]
    x_col = torch.take_along_dim(x, flat, dim=1).reshape(b, n, k, 3)
    h_col = torch.take_along_dim(h, flat, dim=1).reshape(b, n, k, c)
    x_row = x[:, :, None, :].expand_as(x_col)

    # --- forward recompute ---
    rel = x_row - x_col
    radial = torch.sum(rel * rel, -1, keepdim=True)
    dist = torch.sqrt(radial + 1e-20)
    dotf = torch.sum(x_row * x_col, -1, keepdim=True)
    n_rel = torch.sqrt(radial + 1e-20)
    inv_rel = 1.0 / (n_rel + egcl._EPS)
    a = rel * inv_rel
    cr = torch.linalg.cross(x_row, x_col, dim=-1)
    n_cr = torch.sqrt(torch.sum(cr * cr, -1, keepdim=True) + 1e-20)
    inv_cr = 1.0 / (n_cr + egcl._EPS)
    bv = cr * inv_cr
    cv = torch.linalg.cross(a, bv, dim=-1)
    norm = lambda v: torch.sqrt(torch.sum(v * v, -1, keepdim=True) + 1e-20)
    degen = (norm(a) < egcl._DEGEN) | (norm(bv) < egcl._DEGEN) | (norm(cv) < egcl._DEGEN)
    so3 = torch.stack([a, bv, cv], dim=-1).reshape(b, n, k, 9)
    eye = torch.eye(3, dtype=so3.dtype, device=so3.device).reshape(9)
    so3 = torch.where(degen, eye, so3)
    geo = torch.cat([radial, dist, dotf, so3], dim=-1)
    u = (mm(h, p.w1_hrow)[:, :, None, :] + mm(h_col, p.w1_hcol)) + mm(geo, p.w1_geo) + p.b1
    s1 = F.silu(u)
    v = mm(s1, p.w2) + p.b2
    mu = torch.mean(v, -1, keepdim=True)
    sig = torch.rsqrt(torch.mean((v - mu) ** 2, -1, keepdim=True) + 1e-5)
    vhat = (v - mu) * sig
    m = vhat * p.ln_scale + p.ln_bias
    cm_in = mm(m, p.wc0) + p.bc0
    cm = F.silu(cm_in)
    scale = mm(cm, p.wc1)                                   # [B, N, K, 1]

    # --- cotangents of each edge, from its center ---
    dax = dagg_x[:, :, None, :]
    dscale = torch.sum(dax * rel, -1, keepdim=True)
    dcm_in = _dsilu(cm_in) * mmT(dscale, p.wc1)
    dm = dagg_m[:, :, None, :] + mmT(dcm_in, p.wc0)
    g = dm * p.ln_scale
    dv = sig * (g - torch.mean(g, -1, keepdim=True)
                - vhat * torch.mean(g * vhat, -1, keepdim=True))
    du = _dsilu(u) * mmT(dv, p.w2)
    return SimpleNamespace(**locals())


def backward_stages_plain(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                          p: EGCLParams, dagg_m: torch.Tensor, dagg_x: torch.Tensor,
                          accurate: bool = True) -> tuple:
    """The backward's cotangents per edge, as `egcl_backward_plain` computes
    them: (dcm_in, the coord layer's pre-activation; dv, the head layer's
    output; du, the first layer's pre-activation), each [B,N,K,C]."""
    e = _edge_chain(h, x, nbr, p, dagg_m, dagg_x, accurate)
    return e.dcm_in, e.dv, e.du


def egcl_backward_plain(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                        p: EGCLParams, dagg_m: torch.Tensor, dagg_x: torch.Tensor,
                        accurate: bool = True) -> tuple:
    """Plain PyTorch version of the kernels, the chain rule written out on
    [B,N,K,·] edge tensors (no autograd): the layer inputs h [B,N,C],
    x [B,N,3], nbr [B,N,K] and the cotangents dagg_m [B,N,C], dagg_x [B,N,3]
    → (dh, dx, {name: gradient} for EDGE_PARAMS)."""
    e = _edge_chain(h, x, nbr, p, dagg_m, dagg_x, accurate)
    r, mmT, du = e.r, e.mmT, e.du
    outer = lambda a, v: torch.einsum("...o,...i->oi", r(a), r(v))
    total = lambda t: t.reshape(-1, t.shape[-1]).sum(0)
    b, n, c = e.b, e.n, e.c
    grads = dict(
        w1_hrow=torch.einsum("bnko,bni->oi", r(du), r(h)),
        w1_hcol=outer(du, e.h_col), w1_geo=outer(du, e.geo), b1=total(du),
        w2=outer(e.dv, e.s1) * head_block_mask(c, p.head_width, h.device), b2=total(e.dv),
        ln_scale=total(e.dm * e.vhat), ln_bias=total(e.dm),
        wc0=outer(e.dcm_in, e.m), bc0=total(e.dcm_in), wc1=outer(e.dscale, e.cm))

    # --- geometry ---
    dgeo = mmT(du, p.w1_geo)                                # [B, N, K, 12]
    dso3 = dgeo[..., 3:] * (~e.degen).to(dgeo.dtype)        # degenerate → constant
    da = dso3[..., 0::3] + torch.linalg.cross(e.bv, dso3[..., 2::3], dim=-1)
    db = dso3[..., 1::3] + torch.linalg.cross(dso3[..., 2::3], e.a, dim=-1)
    dcr = _normalize_bwd(e.cr, e.n_cr, e.inv_cr, db)
    rel = e.rel
    drel = (e.dax * e.scale + _normalize_bwd(rel, e.n_rel, e.inv_rel, da)
            + 2.0 * rel * dgeo[..., 0:1] + (rel / e.dist) * dgeo[..., 1:2])
    dx_row = drel + e.x_col * dgeo[..., 2:3] + torch.linalg.cross(e.x_col, dcr, dim=-1)
    dx_col = -drel + e.x_row * dgeo[..., 2:3] + torch.linalg.cross(dcr, e.x_row, dim=-1)

    # --- onto centers (sum over K) and onto neighbors (scatter) ---
    rows = (nbr.long() + n * torch.arange(b, device=nbr.device)[:, None, None]).reshape(-1)
    dh = mmT(du, p.w1_hrow).sum(2).reshape(b * n, c)
    dh = dh.index_add(0, rows, mmT(du, p.w1_hcol).reshape(-1, c))
    dx = dx_row.sum(2).reshape(b * n, 3).index_add(0, rows, dx_col.reshape(-1, 3))
    return dh.reshape(b, n, c), dx.reshape(b, n, 3), grads


def _unpack_grads(flat: torch.Tensor, c: int) -> dict:
    """The kernel's packed gradient buffer ([in][out] matrices, the order of
    EDGE_PARAMS) → {name: gradient} in EGCLParams shapes."""
    shapes = dict(w1_hrow=(c, c), w1_hcol=(c, c), w1_geo=(12, c), b1=(c,), w2=(c, c),
                  b2=(c,), ln_scale=(c,), ln_bias=(c,), wc0=(c, c), bc0=(c,), wc1=(c, 1))
    out, o = {}, 0
    for name in EDGE_PARAMS:
        shape = shapes[name]
        size = int(torch.Size(shape).numel())
        t = flat[o:o + size].reshape(shape)
        out[name] = t.T if len(shape) == 2 else t
        o += size
    return out


def _check_cotangents(h, dagg_m, dagg_x):
    b, n, c = h.shape
    for name, t, shape in (("dagg_m", dagg_m, (b, n, c)), ("dagg_x", dagg_x, (b, n, 3))):
        if (t.device != h.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on {h.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(h, x, nbr, p, packed, dagg_m, dagg_x, variant, accurate, dbg=None):
    """Launch `csrc/egcl_backward_tile.cu` ('tile'; fills dbg if given),
    `csrc/egcl_backward_tile_f32.cu` ('tile_f32') or `csrc/egcl_backward.cu`
    ('simt') → (dh_edge, dx_edge, packed grads)."""
    b, n, c = h.shape
    dh, dx = torch.empty_like(h), torch.empty_like(x)
    dh_nbr, dx_nbr = torch.zeros_like(h), torch.zeros_like(x)
    grads = torch.zeros(5 * c * c + 18 * c, dtype=torch.float32, device=h.device)
    outs = [dh, dx, dh_nbr, dx_nbr, grads]
    ptr = lambda t: None if t is None else t.data_ptr()
    if variant == "tile":
        tile = egcl.pack_params_tile(p).to(h.device) if packed is None else packed.tile
        tile_bwd = (egcl.pack_params_tile_bwd(p).to(h.device) if packed is None
                    else packed.tile_bwd)
        name = "egcl_backward_tile_launch"
        ptrs = [h, x, nbr, tile, tile_bwd, dagg_m, dagg_x, *outs, dbg]
        ints = [b, n, nbr.shape[-1], c, p.head_width]
    elif variant == "tile_f32":
        f32 = egcl.pack_params_f32(p).to(h.device) if packed is None else packed.f32
        name = "egcl_backward_tile_f32_launch"
        ptrs = [h, x, nbr, f32, dagg_m, dagg_x, *outs]
        ints = [b, n, nbr.shape[-1], c, p.head_width]
    else:
        simt = egcl.pack_params(p).to(h.device) if packed is None else packed.simt
        name = "egcl_backward_launch"
        ptrs = [h, x, nbr, simt, dagg_m, dagg_x, *outs]
        ints = [b, n, nbr.shape[-1], c, p.head_width, int(not accurate)]
    fn = getattr(build.load(name[:-len("_launch")]), name)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(*(ptr(t) for t in ptrs), *ints, stream)
    build.check(err, name)
    return dh.add_(dh_nbr), dx.add_(dx_nbr), grads


def launch_backward(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                    p: EGCLParams, dagg_m: torch.Tensor, dagg_x: torch.Tensor,
                    accurate: bool = True, packed: egcl.Packed | None = None,
                    variant: str | None = None) -> tuple:
    """The kernel side of `egcl_backward`, whatever the device: checks the
    inputs, picks the variant (`egcl.check_variant`), launches it through
    `LAUNCH` and counts the launch."""
    egcl.check_inputs(h, x, nbr, p.head_width)
    _check_cotangents(h, dagg_m, dagg_x)
    variant = egcl.check_variant(variant, h.shape[-1], nbr.shape[-1], p.head_width, accurate)
    dh, dx, grads = LAUNCH(h, x, nbr, p, packed, dagg_m, dagg_x, variant, accurate)
    egcl_backward.launches += 1
    egcl_backward.launches_by_variant[variant] += 1
    return dh, dx, _unpack_grads(grads, h.shape[-1])


LAUNCH = _launch


def egcl_backward(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                  p: EGCLParams, dagg_m: torch.Tensor, dagg_x: torch.Tensor,
                  accurate: bool = True, packed: egcl.Packed | None = None,
                  variant: str | None = None) -> tuple:
    """Backward of the edge program → (dh_edge [B,N,C], dx_edge [B,N,3],
    {name: gradient} for EDGE_PARAMS). A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel that `egcl.egcl_variant` names for
    its shape and mode, as the forward does: `csrc/egcl_backward_tile.cu`
    ('tile', bf16 mma.sync, fast mode at C=32 and at 32 < C <= 36 with whole
    heads),
    `csrc/egcl_backward_tile_f32.cu` ('tile_f32', fp32, accurate mode at
    C=32 and at 32 < C <= 36 with whole heads) or `csrc/egcl_backward.cu`
    ('simt', every other shape and mode). `variant='simt'` asks for the SIMT kernel where a tile kernel
    would run (to compare the two); a tile variant that is not the shape's
    and mode's raises. Every kernel's neighbor and parameter sums are atomic
    (their order changes from run to run)."""
    if h.device.type == "cpu":
        return egcl_backward_plain(h, x, nbr, p, dagg_m, dagg_x, accurate)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    return launch_backward(h, x, nbr, p, dagg_m, dagg_x, accurate, packed, variant)


egcl_backward.launches = 0
egcl_backward.launches_by_variant = dict.fromkeys(egcl.VARIANTS, 0)


def egcl_backward_tile_stages(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                              p: EGCLParams, dagg_m: torch.Tensor, dagg_x: torch.Tensor
                              ) -> tuple:
    """The tile kernel's per-edge cotangents on the card, (dcm_in, dv, du) as
    `backward_stages_plain` names them, each [B,N,K,C]: a check of the
    backward's fragment plumbing stage by stage. Not a path of the layer
    and not counted."""
    egcl.check_inputs(h, x, nbr, p.head_width)
    _check_cotangents(h, dagg_m, dagg_x)
    c = h.shape[-1]
    if h.device.type != "cuda" or egcl.egcl_variant(c, nbr.shape[-1], p.head_width,
                                                    False) != "tile":
        raise ValueError("the tile kernel takes CUDA tensors at C=32 or 32 < C <= 36 with "
                         "whole heads")
    cp = egcl.tile_width(c)
    dbg = torch.zeros(*nbr.shape, 3 * cp, dtype=torch.float32, device=h.device)
    _launch(h, x, nbr, p, None, dagg_m, dagg_x, "tile", False, dbg)
    return dbg[..., :c], dbg[..., cp:cp + c], dbg[..., 2 * cp:2 * cp + c]


def bwd_tile_probe(d: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """One transposed-operand product on the card as the tile kernel's
    parameter gradients run it: d, a [16, 32] bf16 ([edge][channel]) →
    d.T @ a [32, 32] f32."""
    for t in (d, a):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16 or tuple(t.shape) != (16, 32):
            raise ValueError("d and a must be CUDA bf16 [16,32] tensors")
    d, a = d.contiguous(), a.contiguous()
    out = torch.empty(32, 32, dtype=torch.float32, device=d.device)
    fn = build.load("egcl_backward_tile").egcl_backward_tile_probe
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    with torch.cuda.device(d.device):
        err = fn(d.data_ptr(), a.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(d.device).cuda_stream)
    build.check(err, "egcl_backward_tile_probe")
    return out


class EGCLFunction(torch.autograd.Function):
    """One fused EGCL layer, differentiable (counterpart of
    `egcl_fused_diff`): the forward kernel with agg_m, and a backward that
    runs the node MLP's backward in autograd, then the edge program's
    backward kernel.

        h', x' = EGCLFunction.apply(h, x, nbr, p.head_width, accurate, packed, *p[:-1])

    `p` is an EGCLParams whose tensors may require grad
    (`egcl.live_params(layer)`), passed as positional
    tensors so autograd sees them; `packed` is `pack_for_kernels(p)` or None.
    """

    @staticmethod
    def forward(ctx, h, x, nbr, head_width, accurate, packed, *weights):
        p = EGCLParams(*weights, head_width)
        h_out, x_out, agg_m = egcl.egcl_layer(h, x, nbr, p, accurate, packed,
                                              return_aggm=True)
        ctx.save_for_backward(h, x, nbr, agg_m, *weights)
        ctx.accurate, ctx.head_width, ctx.packed = accurate, p.head_width, packed
        return h_out, x_out

    @staticmethod
    def backward(ctx, dh_out, dx_out):
        h, x, nbr, agg_m, *weights = ctx.saved_tensors
        p = EGCLParams(*weights, ctx.head_width)
        with torch.enable_grad():
            node = {name: getattr(p, name).detach().requires_grad_()
                    for name in _NODE_PARAMS}
            h_, agg_m_ = h.detach().requires_grad_(), agg_m.detach().requires_grad_()
            out = egcl.node_forward(h_, agg_m_, p._replace(**node), ctx.accurate)
            dh_node, dagg_m, *dnode = torch.autograd.grad(
                out, [h_, agg_m_, *node.values()], dh_out)
        dh_edge, dx_edge, dedge = egcl_backward(
            h, x, nbr, p, dagg_m.contiguous(), dx_out.contiguous(), ctx.accurate,
            ctx.packed)
        dweights = dict(dedge, **dict(zip(_NODE_PARAMS, dnode)))
        return (dh_node + dh_edge, dx_out + dx_edge, None, None, None, None,
                *(dweights[name].reshape(getattr(p, name).shape)
                  for name in EGCLParams._fields[:-1]))
