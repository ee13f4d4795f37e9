"""Weighted Kabsch pose solve, its IRLS refinement and the pose covariance,
forward only (counterpart of `ops/kabsch.py`).

Validity is expressed as weights (masked softmax), not data-dependent
slicing; the det(R) < 0 reflection fix is a sign multiply; all-zero weights
degrade to (I, 0).
"""
from __future__ import annotations

import torch

from .numerics import median
from .svd3 import svd3


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over `scores` restricted to mask == 1; all-zero masks → 0."""
    mask = mask.to(scores.dtype)
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(mask > 0, scores, torch.full_like(scores, neg))
    m = torch.amax(masked, dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(masked - m) * mask
    denom = torch.sum(e, dim=dim, keepdim=True)
    return e / torch.clamp(denom, min=1e-30)


def _rotation_from_H_svd(H: torch.Tensor) -> torch.Tensor:
    U, _, Vh = svd3(H)
    V = Vh.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    flip = torch.where(det < 0, -1.0, 1.0).to(H.dtype)
    V = torch.cat([V[..., :, :2], V[..., :, 2:] * flip[..., None, None]], dim=-1)
    return V @ Ut


def _rotation_from_H_quaternion(H: torch.Tensor, iters: int = 60) -> torch.Tensor:
    """Horn's method: R from the dominant eigenvector of the 4x4 symmetric
    K(H), by `iters` shifted power iterations (proper rotations only)."""
    s = lambda i, j: H[..., i, j]
    t = s(0, 0) + s(1, 1) + s(2, 2)
    K = torch.stack([
        torch.stack([t, s(1, 2) - s(2, 1), s(2, 0) - s(0, 2), s(0, 1) - s(1, 0)], -1),
        torch.stack([s(1, 2) - s(2, 1), 2 * s(0, 0) - t, s(0, 1) + s(1, 0),
                     s(0, 2) + s(2, 0)], -1),
        torch.stack([s(2, 0) - s(0, 2), s(0, 1) + s(1, 0), 2 * s(1, 1) - t,
                     s(1, 2) + s(2, 1)], -1),
        torch.stack([s(0, 1) - s(1, 0), s(0, 2) + s(2, 0), s(1, 2) + s(2, 1),
                     2 * s(2, 2) - t], -1),
    ], -2)
    # shift so the wanted eigenvalue dominates (‖K‖₂ ≤ 2‖H‖_F bounds λ_min)
    shift = torch.linalg.norm(H, dim=(-2, -1))[..., None, None] * 2.0 + 1e-6
    Ks = K + shift * torch.eye(4, dtype=K.dtype, device=K.device)
    q = torch.full(K.shape[:-1], 0.5, dtype=K.dtype, device=K.device)
    for _ in range(iters):
        q = (Ks @ q[..., None])[..., 0]
        q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-30)
    w, xq, yq, zq = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (yq**2 + zq**2), 2 * (xq*yq - zq*w), 2 * (xq*zq + yq*w)], -1),
        torch.stack([2 * (xq*yq + zq*w), 1 - 2 * (xq**2 + zq**2), 2 * (yq*zq - xq*w)], -1),
        torch.stack([2 * (xq*zq - yq*w), 2 * (yq*zq + xq*w), 1 - 2 * (xq**2 + yq**2)], -1),
    ], -2)


def kabsch_weighted(src: torch.Tensor, tgt: torch.Tensor, weights: torch.Tensor,
                    eps_reg: float = 1e-6, solver: str = "svd"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, t) minimizing Σ wᵢ‖R srcᵢ + t − tgtᵢ‖² for src/tgt [..., N, 3],
    weights [..., N] (renormalized with +1e-6 on the sum; H gets +1e-6·I)."""
    in_dtype = src.dtype
    src, tgt, w = src.float(), tgt.float(), weights.float()
    wsum = torch.sum(w, dim=-1, keepdim=True)
    empty = wsum <= 0.0
    w = w / (wsum + 1e-6)
    src_c0 = torch.sum(w[..., None] * src, dim=-2, keepdim=True)
    tgt_c0 = torch.sum(w[..., None] * tgt, dim=-2, keepdim=True)
    H = torch.einsum("...n,...ni,...nj->...ij", w, src - src_c0, tgt - tgt_c0)
    H = H + eps_reg * torch.eye(3, dtype=H.dtype, device=H.device)
    if solver == "svd":
        R = _rotation_from_H_svd(H)
    elif solver == "quaternion":
        R = _rotation_from_H_quaternion(H)
    else:
        raise ValueError(f"unknown kabsch solver {solver!r}")
    t = tgt_c0[..., 0, :] - (R @ src_c0[..., 0, :, None])[..., 0]
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand_as(R)
    R = torch.where(empty[..., None], eye, R)
    t = torch.where(empty, torch.zeros_like(t), t)
    return R.to(in_dtype), t.to(in_dtype)


_IRLS_KERNELS = {
    # w(u) = ρ'(u)/u for the residual u = r/σ; shared by kabsch_irls and ICP
    "huber": lambda u: torch.clamp(1.0 / torch.clamp(u, min=1e-12), max=1.0),
    "cauchy": lambda u: 1.0 / (1.0 + u * u),
    "geman": lambda u: 1.0 / (1.0 + u * u) ** 2,
    "welsch": lambda u: torch.exp(-(u * u)),
}


def mad_scale(r: torch.Tensor, min_sigma: float) -> torch.Tensor:
    """1.4826·median|r − median r| over the last axis (keepdims), floored:
    the robust residual scale of kabsch_irls and ICP."""
    med = median(r)
    return torch.clamp(1.4826 * median(torch.abs(r - med)), min=min_sigma)


def kabsch_irls(src: torch.Tensor, tgt: torch.Tensor, weights: torch.Tensor,
                iters: int = 5, kernel: str = "geman", sigma: float | None = None,
                min_sigma: float = 1e-3, solver: str = "svd", eps_reg: float = 1e-6
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Iteratively reweighted weighted Kabsch: the `weights` solve, then
    `iters` times the prior weights times a robust kernel of the residuals
    under the current pose. σ defaults to the MAD scale each iteration.
    Returns (R, t, final weights)."""
    if kernel not in _IRLS_KERNELS:
        raise ValueError(f"unknown IRLS kernel {kernel!r}; "
                         f"expected one of {sorted(_IRLS_KERNELS)}")
    kfn = _IRLS_KERNELS[kernel]
    w0, srcf, tgtf = weights.float(), src.float(), tgt.float()
    R, t = kabsch_weighted(srcf, tgtf, w0, eps_reg=eps_reg, solver=solver)
    w = w0
    for _ in range(iters):
        r = torch.linalg.vector_norm(
            torch.einsum("...ij,...nj->...ni", R, srcf) + t[..., None, :] - tgtf, dim=-1)
        s = mad_scale(r, min_sigma) if sigma is None else sigma
        w = w0 * kfn(r / s)
        R, t = kabsch_weighted(srcf, tgtf, w, eps_reg=eps_reg, solver=solver)
    return R, t, w


def pose_covariance(src: torch.Tensor, tgt: torch.Tensor, R: torch.Tensor,
                    t: torch.Tensor, weights: torch.Tensor,
                    eps: float = 1e-9) -> torch.Tensor:
    """Gauss-Newton covariance [..., 6, 6] over [δω, δt]:
    (σ̂² / N_eff) · (Σᵢ ŵᵢ JᵢᵀJᵢ)⁻¹ with Jᵢ = [−[R sᵢ]ₓ | I]."""
    w = weights.float()
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-12)
    n_eff = 1.0 / (torch.sum(w * w, dim=-1) + 1e-12)
    rs = torch.einsum("...ij,...nj->...ni", R.float(), src.float())
    r = rs + t.float()[..., None, :] - tgt.float()
    sigma2 = torch.sum(w * torch.sum(r * r, dim=-1), dim=-1) / 3.0
    zeros = torch.zeros_like(rs[..., 0])
    ax = torch.stack([
        torch.stack([zeros, -rs[..., 2], rs[..., 1]], -1),
        torch.stack([rs[..., 2], zeros, -rs[..., 0]], -1),
        torch.stack([-rs[..., 1], rs[..., 0], zeros], -1),
    ], -2)                                                     # [..., N, 3, 3]
    eye = torch.eye(3, dtype=ax.dtype, device=ax.device).expand_as(ax)
    J = torch.cat([-ax, eye], dim=-1)                          # [..., N, 3, 6]
    M = torch.einsum("...n,...nij,...nik->...jk", w, J, J)
    M = M + eps * torch.eye(6, dtype=M.dtype, device=M.device)
    return (sigma2 / n_eff)[..., None, None] * torch.linalg.inv(M)
