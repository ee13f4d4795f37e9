"""SE(3) pose helpers the losses, metrics and ICP need (counterpart of the
pure pose functions of `core/se3.py`). Batched over leading dimensions:
poses [..., 4, 4], points [..., N, 3]."""
from __future__ import annotations

import torch


def integrate_trans(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A 4x4 transform from R [..., 3, 3] and t [..., 3] or [..., 3, 1]."""
    if t.shape[-1] == 1:
        t = t[..., 0]
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def decompose_trans(trans: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(R [..., 3, 3], t [..., 3]) of a 4x4 transform."""
    return trans[..., :3, :3], trans[..., :3, 3]


def transform(pts: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Points [..., N, 3] under the transform [..., 4, 4]."""
    R, t = decompose_trans(trans)
    return pts @ R.mT + t[..., None, :]


def concatenate(trans1: torch.Tensor, trans2: torch.Tensor) -> torch.Tensor:
    """trans1 ∘ trans2 (trans2 applies first)."""
    return trans1 @ trans2


def inverse(trans: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform: (Rᵀ, −Rᵀt)."""
    R, t = decompose_trans(trans)
    Rt = R.mT
    return integrate_trans(Rt, -(Rt @ t[..., :, None])[..., 0])


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [..., 3, 3] of a vector [..., 3]."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def matrix_exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map: axis-angle [..., 3] → rotation [..., 3, 3],
    with the Taylor limits of sin θ/θ and (1 − cos θ)/θ² below θ² = 1e-12."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-12
    one = torch.ones_like(theta2)
    theta = torch.sqrt(torch.where(small, one, theta2))
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)
