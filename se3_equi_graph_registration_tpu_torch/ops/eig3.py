"""Closed-form smallest eigenvector of symmetric 3x3 batches (counterpart of
`ops/eig3.py`).

Cardano eigenvalues, cross-product eigenvector extraction and one
(λ_max·I − A) polish multiply, all branch-free elementwise ops. Every guard
of the reference is kept:
- the input is scale-normalized, so the degeneracy thresholds are absolute;
- the Cardano quotient r = det(B)/(2p³) is taken only where p ≥ 1e-6;
- the arccos input is clipped to ±(1 − 1e-6);
- normalizations pass rows with ‖x‖² ≤ 1e-24 through unchanged;
- the polish applies only where the spectral spread is resolvable.
Repeated-smallest spectra (collinear neighborhoods) return a unit vector
orthogonal to the dominant direction; isotropic and zero matrices return +z.
"""
from __future__ import annotations

import math

import torch


def _unit(x: torch.Tensor, floor: float = 1e-24) -> torch.Tensor:
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    safe = torch.where(n2 > floor, n2, torch.ones_like(n2))
    return torch.where(n2 > floor, x / torch.sqrt(safe), x)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _pick(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows [..., 3, 3], idx [...] → rows[..., idx, :]."""
    return torch.gather(rows, -2, idx[..., None, None].expand(idx.shape + (1, 3)))[..., 0, :]


def smallest_eigvec_sym3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector [..., 3] of the smallest eigenvalue of symmetric
    [..., 3, 3] (sign arbitrary; callers orient it). fp32 throughout."""
    A = A.to(torch.float32)
    amax = torch.amax(torch.abs(A), dim=(-1, -2), keepdim=True)
    alive = amax > 1e-30
    An = A / torch.where(alive, amax, torch.ones_like(amax))
    eye = torch.eye(3, dtype=An.dtype, device=An.device)

    q = (An[..., 0, 0] + An[..., 1, 1] + An[..., 2, 2]) / 3.0
    B = An - q[..., None, None] * eye
    p = torch.sqrt(torch.sum(B * B, dim=(-1, -2)) / 6.0 + 1e-30)
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0]))
    small_p = p < 1e-6
    p_safe = torch.where(small_p, torch.ones_like(p), p)
    r = detB / (2.0 * p_safe * p_safe * p_safe)
    r = torch.where(small_p, torch.ones_like(r), r)
    phi = torch.acos(torch.clamp(r, -1.0 + 1e-6, 1.0 - 1e-6)) / 3.0
    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    # cross products of (An − λ_min I) rows span the λ_min eigenspace
    M = An - lam_min[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cand = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)], dim=-2)
    norms = torch.sum(cand * cand, dim=-1)
    v = _pick(cand, torch.argmax(norms, dim=-1))
    nbest = torch.amax(norms, dim=-1)

    # degenerate smallest pair: a unit vector ⟂ the dominant row of M
    rnorms = torch.sum(M * M, dim=-1)
    d = _unit(_pick(M, torch.argmax(rnorms, dim=-1)))
    e = torch.nn.functional.one_hot(torch.argmin(torch.abs(d), dim=-1), 3).to(An.dtype)
    fb = _unit(_cross(d, e))
    zhat = torch.tensor([0.0, 0.0, 1.0], dtype=An.dtype, device=An.device).expand_as(d)
    fb = torch.where((torch.amax(rnorms, dim=-1) < 1e-12)[..., None], zhat, fb)
    v = _unit(torch.where((nbest < 1e-12)[..., None], fb, v))

    # polish: w = (λ_max I − An) v, where the spread is resolvable
    Av = (An[..., 0] * v[..., None, 0] + An[..., 1] * v[..., None, 1]) + An[..., 2] * v[..., None, 2]
    w = lam_max[..., None] * v - Av
    wn2 = torch.sum(w * w, dim=-1, keepdim=True)
    gap = (lam_max - lam_min)[..., None]
    ok = wn2 > torch.clamp(1e-6 * gap * gap, min=1e-24)
    return torch.where(ok, _unit(w), v)
