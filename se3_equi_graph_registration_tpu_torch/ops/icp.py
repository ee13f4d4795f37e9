"""Batched ICP refinement: point, plane, symmetric and GICP modes
(counterpart of `ops/icp.py`).

Each of the `iters` steps re-associates the posed source with its nearest
target point (one distance matmul and a row argmin) and re-solves: point
mode by a weighted Kabsch from the original source, the other modes by one
damped 6x6 Gauss-Newton step applied through the Rodrigues map. Outlier
rejection is a weight: a hard `tau` gate, a `trim` quantile, Chetverikov's
automatic trim ('auto'), or a MAD-scaled robust kernel. `_guard_step`
rejects non-finite or implausible steps (the pose is kept).

Singular systems: `torch.linalg.solve`/`inv` raise and check with a device
sync; this uses `solve_ex`/`inv_ex`, which return non-finite values as JAX
does, and the guard zeroes them.

`icp_refine_multiscale` (the voxel pyramid) needs `ops/voxel.py`, which is
not ported yet (ROADMAP Queue A item 5).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.se3 import matrix_exp_so3, skew
from .fpfh import estimate_normals as _estimate_normals
from .kabsch import _IRLS_KERNELS, kabsch_weighted, mad_scale
from .knn import gather_rows, pairwise_sq_dists
from .numerics import quantile


def nearest_neighbor(query: torch.Tensor, points: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN of query [..., N, 3] in points [..., M, 3]: (idx [..., N] int64,
    squared distance [..., N], clamped at 0). Ties go to the lowest index."""
    d2 = pairwise_sq_dists(query.float(), points.float())
    idx = torch.argmin(d2, dim=-1)
    return idx, torch.gather(d2, -1, idx[..., None])[..., 0]


def estimate_normals(points: torch.Tensor, k: int = 16) -> torch.Tensor:
    """Unit PCA normals [..., M, 3] (viewpoint orientation; ICP squares the
    sign out)."""
    return _estimate_normals(points.float(), k=k)


def point_covariances(points: torch.Tensor, k: int = 16, eps: float = 1e-3,
                      normals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GICP plane-shaped covariances [..., M, 3, 3] = I − (1 − eps)·n nᵀ."""
    nrm = estimate_normals(points, k=k) if normals is None else normals.float()
    eye = torch.eye(3, dtype=torch.float32, device=nrm.device)
    return eye - (1.0 - eps) * nrm[..., :, None] * nrm[..., None, :]


def icp_refine(src: torch.Tensor, tgt: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
               iters: int = 10, tau: float = 0.0, kernel: str = "welsch",
               min_sigma: float = 1e-3, solver: str = "svd",
               prior_weights: Optional[torch.Tensor] = None, mode: str = "point",
               tgt_normals: Optional[torch.Tensor] = None,
               src_normals: Optional[torch.Tensor] = None, normals_k: int = 16,
               trim: Union[float, str] = 0.0, min_trim: float = 0.2,
               src_cov: Optional[torch.Tensor] = None,
               tgt_cov: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ICP of the clouds src [..., N, 3] and tgt [..., M, 3] from (R, t).
    Returns (R, t, the last iteration's weights [..., N])."""
    if kernel not in _IRLS_KERNELS:
        raise ValueError(f"unknown ICP kernel {kernel!r}; expected one of {sorted(_IRLS_KERNELS)}")
    if mode not in ("point", "plane", "symmetric", "gicp"):
        raise ValueError(f"unknown ICP mode {mode!r}; expected 'point', 'plane', "
                         "'symmetric', or 'gicp'")
    if isinstance(trim, str):
        if trim != "auto":
            raise ValueError(f"trim must be a fraction in [0, 1) or 'auto', got {trim!r}")
    elif not 0.0 <= trim < 1.0:
        raise ValueError(f"trim must be in [0, 1), got {trim}")
    kfn = _IRLS_KERNELS[kernel]
    srcf, tgtf = src.float(), tgt.float()
    w0 = torch.ones(srcf.shape[:-1], device=srcf.device) if prior_weights is None \
        else prior_weights.float()
    if mode in ("plane", "symmetric"):
        normals = estimate_normals(tgtf, normals_k) if tgt_normals is None else tgt_normals.float()
    if mode == "symmetric":
        nsrc = estimate_normals(srcf, normals_k) if src_normals is None else src_normals.float()
    if mode == "gicp":
        C_src = point_covariances(srcf, normals_k) if src_cov is None else src_cov.float()
        C_tgt = point_covariances(tgtf, normals_k) if tgt_cov is None else tgt_cov.float()

    def auto_cut(resid):
        """Chetverikov's overlap: argmin of ψ(ξ) = e(ξ)/ξ³ over every prefix
        of the sorted residuals (ξ ≥ min_trim)."""
        n = resid.shape[-1]
        r_sorted = torch.sort(resid, dim=-1).values
        m = torch.arange(1, n + 1, dtype=torch.float32, device=resid.device)
        e = torch.cumsum(r_sorted * r_sorted, dim=-1) / m
        xi = m / n
        psi = (e + 1e-12) / (xi ** 3)
        psi = torch.where(xi >= min_trim, psi, torch.full_like(psi, torch.inf))
        return torch.gather(r_sorted, -1, torch.argmin(psi, dim=-1, keepdim=True))

    def robust(resid):
        if tau > 0:
            return w0 * (resid <= tau)
        if trim == "auto":
            return w0 * (resid <= auto_cut(resid))
        if trim > 0:
            return w0 * (resid <= quantile(resid, trim))
        return w0 * kfn(resid / mad_scale(resid, min_sigma))

    # trust-region radius of a GN translation step: 2x the target's radius
    t_scale = 2.0 * torch.sqrt(torch.amax(torch.sum(
        (tgtf - torch.mean(tgtf, dim=-2, keepdim=True)) ** 2, dim=-1), dim=-1))
    eye3 = torch.eye(3, dtype=torch.float32, device=srcf.device)
    eye6 = torch.eye(6, dtype=torch.float32, device=srcf.device)

    def guard_step(delta):
        """Zero a step that is non-finite, rotates by π or more, or moves
        beyond t_scale: the pose is kept, as in an all-rejected iteration."""
        ok = (torch.all(torch.isfinite(delta), dim=-1)
              & (torch.sum(delta[..., :3] ** 2, dim=-1) < torch.pi ** 2)
              & (torch.sum(delta[..., 3:] ** 2, dim=-1) < t_scale ** 2))
        return torch.where(ok[..., None], delta, torch.zeros_like(delta))

    def gn_update(H, g, R_, t_):
        damp = 1e-8 * torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / 6.0 + 1e-12
        H = H + damp[..., None, None] * eye6
        delta = guard_step(torch.linalg.solve_ex(H, g[..., None])[0][..., 0])
        Rd = matrix_exp_so3(delta[..., :3])
        return Rd @ R_, (Rd @ t_[..., None])[..., 0] + delta[..., 3:]

    R, t = R.float(), t.float()
    w = w0
    for _ in range(iters):
        x = torch.einsum("...ij,...nj->...ni", R, srcf) + t[..., None, :]
        nn, d2 = nearest_neighbor(x, tgtf)
        y = gather_rows(tgtf, nn)
        if mode == "point":
            w = robust(torch.sqrt(d2))
            R2, t2 = kabsch_weighted(srcf, y, w, solver=solver)
            ok = torch.sum(w, dim=-1) > 0
            R = torch.where(ok[..., None, None], R2, R)
            t = torch.where(ok[..., None], t2, t)
        elif mode == "gicp":
            w = robust(torch.sqrt(d2))
            Cy = gather_rows(C_tgt.flatten(-2), nn).unflatten(-1, (3, 3))
            Cx = torch.einsum("...ab,...nbc,...dc->...nad", R, C_src, R)
            Minv = torch.linalg.inv_ex(Cy + Cx + 1e-6 * eye3)[0]
            J = torch.cat([-skew(x), eye3.expand(x.shape + (3,))], dim=-1)   # [..., N, 3, 6]
            H = torch.einsum("...n,...nai,...nab,...nbj->...ij", w, J, Minv, J)
            g = torch.einsum("...n,...nai,...nab,...nb->...i", w, J, Minv, x - y)
            R, t = gn_update(H, -g, R, t)
        else:
            n = gather_rows(normals, nn)
            if mode == "symmetric":
                nx = torch.einsum("...ij,...nj->...ni", R, nsrc)
                sgn = torch.sign(torch.sum(nx * n, dim=-1, keepdim=True))
                n = n + torch.where(sgn == 0.0, torch.ones_like(sgn), sgn) * nx
            r = torch.sum(n * (x - y), dim=-1)
            w = robust(torch.abs(r))
            a = torch.cat([torch.linalg.cross(x, n, dim=-1), n], dim=-1)      # [..., N, 6]
            A = torch.einsum("...n,...ni,...nj->...ij", w, a, a)
            rhs = -torch.einsum("...ni,...n->...i", a, w * r)
            R, t = gn_update(A, rhs, R, t)
    return R, t, w
