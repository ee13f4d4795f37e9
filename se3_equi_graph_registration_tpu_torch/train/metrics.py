"""Evaluation metrics: RRE / RTE / registration recall / precision
(counterpart of `train/metrics.py`)."""
from __future__ import annotations

import torch


def calculate_pose_error(gt_pose: torch.Tensor, pred_pose: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rotation error in degrees, translation error in cm) for [..., 4, 4]."""
    trans_err = torch.linalg.norm(gt_pose[..., :3, 3] - pred_pose[..., :3, 3], dim=-1) * 100.0
    rel = gt_pose[..., :3, :3].transpose(-1, -2) @ pred_pose[..., :3, :3]
    trace = rel.diagonal(dim1=-2, dim2=-1).sum(-1)
    rot_err = torch.rad2deg(torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)))
    return rot_err, trans_err


def registration_recall(pred_pose: torch.Tensor, src_pts: torch.Tensor,
                        tgt_pts: torch.Tensor, tau: float = 0.09
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Recall = sqrt(TP/N), precision = TP/N under inlier threshold tau."""
    R = pred_pose[..., :3, :3]
    t = pred_pose[..., :3, 3]
    d = torch.linalg.norm(src_pts @ R.transpose(-1, -2) + t[..., None, :] - tgt_pts, dim=-1)
    precision = torch.mean((d < tau).to(torch.float32), dim=-1)
    return torch.sqrt(precision), precision
