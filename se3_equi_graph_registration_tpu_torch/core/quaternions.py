"""Quaternion ↔ rotation-matrix conversions (counterpart of
`core/quaternions.py`), batched and branch-free: all four of Shepperd's
branches, each selected by `where`. Quaternions are (w, x, y, z),
scalar first, unless `scalar_first=False`."""
from __future__ import annotations

import torch


def rotation_matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotations [..., 3, 3] → unit quaternions [..., 4] (w, x, y, z): the
    four candidates, selected by the largest of (trace, R00, R11, R22)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    trace = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = safe_sqrt(trace + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)
    cond0 = (trace > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quaternion_to_matrix(q: torch.Tensor, scalar_first: bool = True) -> torch.Tensor:
    """Quaternions [..., 4] (normalized here) → rotations [..., 3, 3];
    `scalar_first=False` takes (x, y, z, w)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    if scalar_first:
        qw, qx, qy, qz = q.unbind(-1)
    else:
        qx, qy, qz, qw = q.unbind(-1)
    rows = [
        [1 - 2 * (qy ** 2 + qz ** 2), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx ** 2 + qz ** 2), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx ** 2 + qy ** 2)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def center_and_normalize(src_pts: torch.Tensor, tar_pts: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Point sets [B, N, 3] centered at their means, each row scaled to unit
    norm."""
    src_c = src_pts - src_pts.mean(dim=-2, keepdim=True)
    tar_c = tar_pts - tar_pts.mean(dim=-2, keepdim=True)
    return (src_c / torch.linalg.vector_norm(src_c, dim=-1, keepdim=True),
            tar_c / torch.linalg.vector_norm(tar_c, dim=-1, keepdim=True))
