"""Evaluation metrics: RRE / RTE / registration recall / precision / F1
(counterpart of `train/metrics.py`)."""
from __future__ import annotations

import numpy as np
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


def f1_score(precision, recall):
    """Elementwise F1 of tensors or arrays."""
    return 2.0 * precision * recall / (precision + recall + 1e-6)


def summarize(rot_errs: np.ndarray, trans_errs: np.ndarray,
              recalls: np.ndarray, precisions: np.ndarray) -> dict:
    """Host-side averages, as the reference's evaluation script reports them."""
    f1 = f1_score(precisions, recalls)
    return {
        "avg_rotation_error_deg": float(np.mean(rot_errs)),
        "avg_translation_error_cm": float(np.mean(trans_errs)),
        "avg_registration_recall": float(np.mean(recalls)),
        "avg_precision": float(np.mean(precisions)),
        "avg_f1": float(np.mean(f1)),
        "num_pairs": int(len(rot_errs)),
    }
