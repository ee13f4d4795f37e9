"""Backward of the fused EGCL layer: the CUDA kernel `csrc/egcl_backward.cu`,
its plain version, and `EGCLFunction`, the layer as a differentiable
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


def egcl_backward_plain(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                        p: EGCLParams, dagg_m: torch.Tensor, dagg_x: torch.Tensor,
                        accurate: bool = True) -> tuple:
    """Plain PyTorch version of the kernel, the chain rule written out on
    [B,N,K,·] edge tensors (no autograd): the layer inputs h [B,N,C],
    x [B,N,3], nbr [B,N,K] and the cotangents dagg_m [B,N,C], dagg_x [B,N,3]
    → (dh, dx, {name: gradient} for EDGE_PARAMS)."""
    r = egcl._round(not accurate)
    mm = lambda a, w: torch.matmul(r(a), r(w).T)      # a · wᵀ, w [out, in]
    mmT = lambda a, w: torch.matmul(r(a), r(w))       # a · w: back through w
    outer = lambda a, v: torch.einsum("...o,...i->oi", r(a), r(v))
    total = lambda t: t.reshape(-1, t.shape[-1]).sum(0)
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
    grads = dict(
        w1_hrow=torch.einsum("bnko,bni->oi", r(du), r(h)),
        w1_hcol=outer(du, h_col), w1_geo=outer(du, geo), b1=total(du),
        w2=outer(dv, s1) * head_block_mask(c, p.head_width, h.device), b2=total(dv),
        ln_scale=total(dm * vhat), ln_bias=total(dm),
        wc0=outer(dcm_in, m), bc0=total(dcm_in), wc1=outer(dscale, cm))

    # --- geometry ---
    dgeo = mmT(du, p.w1_geo)                                # [B, N, K, 12]
    dso3 = dgeo[..., 3:] * (~degen).to(dgeo.dtype)          # degenerate → constant
    da = dso3[..., 0::3] + torch.linalg.cross(bv, dso3[..., 2::3], dim=-1)
    db = dso3[..., 1::3] + torch.linalg.cross(dso3[..., 2::3], a, dim=-1)
    dcr = _normalize_bwd(cr, n_cr, inv_cr, db)
    drel = (dax * scale + _normalize_bwd(rel, n_rel, inv_rel, da)
            + 2.0 * rel * dgeo[..., 0:1] + (rel / dist) * dgeo[..., 1:2])
    dx_row = drel + x_col * dgeo[..., 2:3] + torch.linalg.cross(x_col, dcr, dim=-1)
    dx_col = -drel + x_row * dgeo[..., 2:3] + torch.linalg.cross(dcr, x_row, dim=-1)

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


def egcl_backward(h: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                  p: EGCLParams, dagg_m: torch.Tensor, dagg_x: torch.Tensor,
                  accurate: bool = True, packed: egcl.Packed | None = None) -> tuple:
    """Backward of the edge program → (dh_edge [B,N,C], dx_edge [B,N,3],
    {name: gradient} for EDGE_PARAMS). A CPU tensor takes the plain version;
    a CUDA tensor launches `csrc/egcl_backward.cu`, whose neighbor and
    parameter sums are atomic (their order changes from run to run)."""
    if h.device.type == "cpu":
        return egcl_backward_plain(h, x, nbr, p, dagg_m, dagg_x, accurate)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    egcl.check_inputs(h, x, nbr, p.head_width)
    b, n, c = h.shape
    for name, t, shape in (("dagg_m", dagg_m, (b, n, c)), ("dagg_x", dagg_x, (b, n, 3))):
        if (t.device != h.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on {h.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    simt = egcl.pack_params(p).to(h.device) if packed is None else packed.simt
    dh, dx = torch.empty_like(h), torch.empty_like(x)
    dh_nbr, dx_nbr = torch.zeros_like(h), torch.zeros_like(x)
    grads = torch.zeros(5 * c * c + 18 * c, dtype=torch.float32, device=h.device)
    fn = build.load("egcl_backward").egcl_backward_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(h.data_ptr(), x.data_ptr(), nbr.data_ptr(), simt.data_ptr(),
                 dagg_m.data_ptr(), dagg_x.data_ptr(), dh.data_ptr(), dx.data_ptr(),
                 dh_nbr.data_ptr(), dx_nbr.data_ptr(), grads.data_ptr(),
                 b, n, nbr.shape[-1], c, p.head_width, int(not accurate), stream)
    build.check(err, "egcl_backward_launch")
    egcl_backward.launches += 1
    return dh.add_(dh_nbr), dx.add_(dx_nbr), _unpack_grads(grads, c)


egcl_backward.launches = 0


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
