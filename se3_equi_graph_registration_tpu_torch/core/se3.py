"""SE(3) pose helpers the losses and metrics need (counterpart of the pure
pose functions of `core/se3.py`). Batched over leading dimensions: poses
[..., 4, 4], points [..., N, 3]."""
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
