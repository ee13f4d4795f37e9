"""Pose-graph optimization (multiway registration) (counterpart of
`ops/pose_graph.py`).

Pairwise registration leaves a scan sequence with drift: V fragment poses
constrained by E relative-pose measurements (odometry pairs + loop closures,
e.g. the 3DMatch `gt.log` graphs that utils/trajectory.py reads). Fusing them
is classic pose-graph optimization — open3d's `global_optimization`, g2o
territory. The formulation, as the reference's:

- state: absolute poses (R_i, t_i); retraction R_i·exp_so3(δω), t_i + δt;
- residual per edge (i, j) with measurement (R_ij, t_ij):
  [vee(log(R_ijᵀ R_iᵀ R_j)), R_iᵀ(t_j − t_i) − t_ij], smooth everywhere
  (atan2/Taylor-blended log coefficient — NO arccos, whose gradient blows
  up exactly at convergence);
- each Gauss-Newton step builds the full Jacobian with `torch.func.jacfwd`
  over the [V, 6] tangent (autodiff replaces hand-derived SE(3) adjoint
  Jacobians), solves the damped normal equations as ONE dense [6V, 6V]
  `torch.linalg.solve`, and retracts;
- the gauge is fixed by a stiff prior (1e8) on `anchor`'s tangent block;
  the `iters` steps are a Python loop.

Every float32 product runs under `numerics.fp32_matmuls`: beside the 1e8
prior on H's diagonal, TF32's 10-bit mantissa in JᵀJ would wreck the
solve. The solve is a library call, as it is a plain dense solve in the
reference. Dense 6V×6V is the right trade for fragment-scale graphs
(V ≲ a few hundred: 3DMatch scenes are ~50-60 fragments).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.se3 import matrix_exp_so3
from ..device import resolve_device
from .kabsch import _IRLS_KERNELS
from .numerics import fp32_matmuls, median

__all__ = ["optimize_pose_graph", "optimize_trajectory"]

Device = Union[str, torch.device, None]


def _log_so3_vee(R: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector of R [..., 3, 3]; smooth through θ = 0.

    ω = c(θ)·vee(R − Rᵀ)/2 with c = θ/sin θ, θ = atan2(|s|, (tr−1)/2).
    Unlike core.se3.matrix_log_so3 (which hard-zeroes small angles — fine
    for values, fatal for the Gauss-Newton Jacobian at convergence), both
    the θ ≈ 0 branch (Taylor 1 + θ²/6) and the switch are differentiable.
    Valid for θ < π − ε, which a pose-graph residual always satisfies.
    """
    s = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1) * 0.5
    cos = (torch.diagonal(R, dim1=-2, dim2=-1).sum(-1) - 1.0) * 0.5
    # guarded norm: sqrt'(0) = inf would NaN the Jacobian exactly at zero
    # residual (an EXACT rotation match is a normal GN state, not an edge
    # case) — in the small branch sin/theta are constants with zero
    # derivatives and ω = 1·s carries the identity-limit derivative
    sum2 = torch.sum(s * s, dim=-1)
    small = sum2 < 1e-12
    sin = torch.sqrt(torch.where(small, 1.0, sum2))
    theta = torch.atan2(torch.where(small, 0.0, sin), cos)
    c = torch.where(small, 1.0 + theta * theta / 6.0, theta / sin)
    return c[..., None] * s


def optimize_pose_graph(R0, t0, edges, R_rel, t_rel, weights=None,
                        iters: int = 10, damping: float = 1e-6,
                        anchor: int = 0, rot_weight: float = 1.0,
                        robust: Optional[str] = None, min_sigma: float = 1e-4,
                        robust_anneal: float = 0.7, device: Device = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton over absolute poses given relative measurements.

    R0 [V, 3, 3] / t0 [V, 3]: initial absolute poses (frame→world).
    edges [E, 2] int: (i, j) pairs. R_rel/t_rel: measured pose of frame j
    expressed in frame i (what a pairwise registration of fragment j onto
    fragment i produces). weights [E]: per-edge confidence (e.g. inverse
    residual variance from `pose_covariance`, or registration recall);
    default uniform. `rot_weight` scales the rotation residual relative to
    translation (unit balance). Inputs are arrays or tensors; they are
    moved to `device` (the card unless device='cpu'). Returns optimized
    (R [V, 3, 3], t [V, 3]) float32 tensors there, with pose `anchor` held
    fixed (stiff gauge prior).

    `robust` ('huber' | 'cauchy' | 'geman' | 'welsch', default None =
    plain least squares) re-weights edges each GN round by a kernel of
    their residual NORM — the IRLS form of switchable constraints. The
    scale follows graduated non-convexity: round k uses
    max(MAD, max|r₀|·robust_anneal^k, min_sigma) — starting near least
    squares and annealing, since pure MAD deadlocks when the init itself
    embeds a bad edge (most edges then agree with the wrong init and the
    informative loop closures are crushed). robust_anneal=0 is pure MAD.
    """
    if robust is not None and robust not in _IRLS_KERNELS:
        raise ValueError(f"unknown robust kernel {robust!r}; "
                         f"expected one of {sorted(_IRLS_KERNELS)} or None")
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(a, device=dev).to(torch.float32)

    R0, t0, Rm, tm = f32(R0), f32(t0), f32(R_rel), f32(t_rel)
    edges = torch.as_tensor(edges, device=dev).to(torch.int64)
    V, E = R0.shape[0], edges.shape[0]
    w_e = (torch.ones(E, dtype=torch.float32, device=dev) if weights is None
           else f32(weights))
    ei, ej = edges[:, 0], edges[:, 1]

    def residuals(delta, R, t):
        """[E, 6] stacked (rotation, translation) residuals at tangent
        `delta` [V, 6] about (R, t) — autodiff of THIS gives the GN
        Jacobian, replacing hand-derived adjoints."""
        Rp = R @ matrix_exp_so3(delta[:, :3])
        tp = t + delta[:, 3:]
        Ri, Rj = Rp[ei], Rp[ej]
        R_err = torch.einsum("eab,eca,ecd->ebd", Rm, Ri, Rj)  # Rmᵀ Riᵀ Rj
        r_rot = _log_so3_vee(R_err) * rot_weight
        r_t = torch.einsum("eab,ea->eb", Ri, tp[ej] - tp[ei]) - tm
        return torch.cat([r_rot, r_t], dim=-1)

    with fp32_matmuls():
        gauge = torch.zeros(V, dtype=torch.float32, device=dev)
        gauge[anchor] = 1.0
        prior = 1e8 * torch.repeat_interleave(gauge, 6)
        zero = torch.zeros(V, 6, dtype=torch.float32, device=dev)
        r_init = residuals(zero, R0, t0)
        s_max = torch.sqrt(torch.clamp(torch.max(torch.sum(r_init * r_init, -1)),
                                       min=1e-20)) + min_sigma
        anneal = torch.tensor(robust_anneal, dtype=torch.float32, device=dev)
        R, t = R0, t0
        for k in range(iters):
            r_raw = residuals(zero, R, t)                       # [E, 6]
            w_it = w_e
            if robust is not None:
                # IRLS multiplier held constant within the step (standard)
                rn = torch.sqrt(torch.clamp(torch.sum(r_raw * r_raw, -1), min=1e-20))
                med = median(rn)
                s = torch.clamp(1.4826 * median(torch.abs(rn - med)), min=min_sigma)
                if robust_anneal > 0:
                    s = torch.maximum(s, s_max * anneal ** float(k))
                w_it = w_e * _IRLS_KERNELS[robust](rn / s)
            sw = torch.sqrt(torch.clamp(w_it, min=0.0))[:, None]
            r = (r_raw * sw).reshape(-1)                        # [6E]
            J = torch.func.jacfwd(
                lambda d: (residuals(d, R, t) * sw).reshape(-1))(zero)
            J = J.reshape(r.shape[0], V * 6)                    # [6E, 6V]
            H = J.T @ J
            H = H + torch.diag(prior + damping * (1.0 + torch.diag(H)))
            delta = -torch.linalg.solve(H, J.T @ r).reshape(V, 6)
            R, t = R @ matrix_exp_so3(delta[:, :3]), t + delta[:, 3:]
    return R, t


def optimize_trajectory(poses, edges, rel, weights=None, device: Device = None,
                        **kw) -> torch.Tensor:
    """4×4 convenience wrapper: poses [V, 4, 4], rel [E, 4, 4] measured
    inv(T_i) @ T_j — the schema utils/trajectory.py reads from gt.log files.
    Returns optimized [V, 4, 4] float32 on `device` (the card unless
    device='cpu')."""
    dev = resolve_device(device)
    poses = torch.as_tensor(poses, device=dev).to(torch.float32)
    rel = torch.as_tensor(rel, device=dev).to(torch.float32)
    R, t = optimize_pose_graph(poses[:, :3, :3], poses[:, :3, 3], edges,
                               rel[:, :3, :3], rel[:, :3, 3], weights=weights,
                               device=dev, **kw)
    out = torch.eye(4, dtype=torch.float32, device=dev).repeat(poses.shape[0], 1, 1)
    out[:, :3, :3] = R
    out[:, :3, 3] = t
    return out
