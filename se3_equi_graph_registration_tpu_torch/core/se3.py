"""SE(3) pose algebra (counterpart of `core/se3.py`). Batched over leading
dimensions: poses [..., 4, 4], points [..., N, 3]. The random draws take an
explicit `torch.Generator` (JAX's take a key): the two frameworks give
different numbers from the same seed, the same distributions."""
from __future__ import annotations

import math

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


def _axis_rotation(angle: torch.Tensor, axis: int) -> torch.Tensor:
    """Rotation [3, 3] by `angle` about the x (0), y (1) or z (2) axis."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    flat = {0: [o, z, z, z, c, -s, z, s, c],
            1: [c, z, s, z, o, z, -s, z, c],
            2: [c, -s, z, s, c, z, z, z, o]}[axis]
    return torch.stack(flat).reshape(3, 3)


def rotation_matrix(generator: torch.Generator, num_axis: int, augment_rotation: float,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Random rotation [3, 3] for augmentation, on the generator's device:
    num_axis 0 → identity; 1 → about one axis drawn from x, y, z by an angle
    ~ U(0, 2π·augment_rotation); 3 → Rx @ Ry @ Rz, each angle drawn so."""
    dev = generator.device
    if num_axis == 0:
        return torch.eye(3, dtype=dtype, device=dev)
    if num_axis not in (1, 3):
        raise ValueError(f"num_axis must be 0, 1 or 3, got {num_axis}")
    angles = torch.rand(3, generator=generator, dtype=dtype, device=dev) * (
        2.0 * math.pi * augment_rotation)
    if num_axis == 1:
        axis = int(torch.randint(0, 3, (), generator=generator, device=dev))
        return _axis_rotation(angles[axis], axis)
    return _axis_rotation(angles[0], 0) @ _axis_rotation(angles[1], 1) @ _axis_rotation(
        angles[2], 2)


def translation_matrix(generator: torch.Generator, augment_translation: float,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Random translation [3] ~ U(0, 1)·augment_translation (the reference
    draws rand(3)·t, not a Gaussian)."""
    return torch.rand(3, generator=generator, dtype=dtype,
                      device=generator.device) * augment_translation


def random_pose(generator: torch.Generator, num_axis: int = 3, augment_rotation: float = 1.0,
                augment_translation: float = 0.5, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """Random rigid transform [4, 4]: `rotation_matrix`, then
    `translation_matrix`, from one generator."""
    R = rotation_matrix(generator, num_axis, augment_rotation, dtype)
    return integrate_trans(R, translation_matrix(generator, augment_translation, dtype))


def rotation_geodesic_angle(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle (radians) between rotations [..., 3, 3]."""
    R = R1.mT @ R2
    trace = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    return torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))


def pose_error(gt_pose: torch.Tensor, pred_pose: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rotation error in degrees, translation error in centimetres) of
    poses [..., 4, 4]."""
    rot_err = torch.rad2deg(rotation_geodesic_angle(gt_pose[..., :3, :3],
                                                    pred_pose[..., :3, :3]))
    trans_err = torch.linalg.vector_norm(gt_pose[..., :3, 3] - pred_pose[..., :3, 3],
                                         dim=-1) * 100.0
    return rot_err, trans_err


def matrix_log_so3(R: torch.Tensor) -> torch.Tensor:
    """Matrix logarithm of rotations [..., 3, 3] → skew matrices [..., 3, 3];
    0 where the angle is below 1e-6. The values are the JAX package's; the
    gradient is finite at zero residual too: the small angles are found on
    a detached angle and take arccos(0) in place of arccos(1), whose slope
    is infinite (the JAX package's gradient is NaN there)."""
    trace = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    c = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    small = torch.abs(torch.arccos(c.detach())) < 1e-6
    theta = torch.arccos(torch.where(small, torch.zeros_like(c), c))
    safe = torch.where(small, torch.ones_like(theta), theta)
    coef = safe / (2.0 * torch.sin(safe))
    log_R = coef[..., None, None] * (R - R.mT)
    return torch.where(small[..., None, None], torch.zeros_like(R), log_R)
