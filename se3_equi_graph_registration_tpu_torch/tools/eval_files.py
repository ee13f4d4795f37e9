"""File-based pairwise evaluation harness (counterpart of the JAX package's
`tools/eval_files.py`; numpy on the host).

Capability parity with the reference's tools/evaluation_metrics.py:6-12
(`quaternion_to_matrix` from a 7-value qx qy qz qw tx ty tz line) and :45-104
(`evaluate_pairwise_frames`: gt .pkl files + predicted-pose .txt files →
averaged RRE/RTE/recall/F1 report written to evaluation_results.txt).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..core.quaternions import quaternion_to_matrix as _quat_to_mat_torch


def quaternion_line_to_matrix(values) -> np.ndarray:
    """7 floats (qx qy qz qw tx ty tz, scipy convention like the reference's
    R.from_quat) → 4x4 pose. The rotation is computed in float32 and held in
    the float64 pose, as the JAX package computes it (its arrays are
    float32): `calculate_pose_error_np` takes arccos near trace 3, where a
    float32-against-float64 rounding reads as hundredths of a degree."""
    q = np.asarray(values, np.float64)
    R = _quat_to_mat_torch(torch.from_numpy(q[:4].astype(np.float32)),
                           scalar_first=False).numpy()
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = q[4:7]
    return T


def calculate_pose_error_np(gt_pose, pred_pose) -> tuple[float, float]:
    trans_err = float(np.linalg.norm(gt_pose[:3, 3] - pred_pose[:3, 3]) * 100)
    rel = gt_pose[:3, :3].T @ pred_pose[:3, :3]
    rot_err = float(np.degrees(np.arccos(
        np.clip((np.trace(rel) - 1) / 2, -1.0, 1.0))))
    return rot_err, trans_err


def registration_recall_np(pred_pose, src_pts, tgt_pts, tau=0.09):
    warp = src_pts @ pred_pose[:3, :3].T + pred_pose[:3, 3]
    d = np.linalg.norm(warp - tgt_pts, axis=1)
    tp = float(np.sum(d < tau))
    precision = tp / max(len(src_pts), 1)
    return float(np.sqrt(precision)), precision


def evaluate_pairwise_frames(gt_files, pred_files, gt_dir, pred_dir,
                             save_dir) -> dict:
    assert len(gt_files) == len(pred_files)
    rot_errs, trans_errs, recalls, precisions, f1s = [], [], [], [], []
    for gt_name, pred_name in zip(gt_files, pred_files):
        with open(os.path.join(gt_dir, gt_name), "rb") as f:
            gt = pickle.load(f)
        with open(os.path.join(pred_dir, pred_name)) as f:
            pred_pose = quaternion_line_to_matrix(
                list(map(float, f.readline().split())))
        rot, trans = calculate_pose_error_np(np.asarray(gt["gt_pose"]), pred_pose)
        recall, precision = registration_recall_np(
            pred_pose, np.asarray(gt["xyz_0"]), np.asarray(gt["xyz_1"]))
        rot_errs.append(rot)
        trans_errs.append(trans)
        recalls.append(recall)
        precisions.append(precision)
        f1s.append(2 * precision * recall / (precision + recall + 1e-6))

    summary = {
        "avg_rotation_error_deg": float(np.mean(rot_errs)),
        "avg_translation_error_cm": float(np.mean(trans_errs)),
        "avg_registration_recall": float(np.mean(recalls)),
        "avg_f1": float(np.mean(f1s)),
    }
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "evaluation_results.txt"), "w") as f:
        f.write(f"Average Rotation Error: {summary['avg_rotation_error_deg']:.4f} degrees\n")
        f.write(f"Average Translation Error: {summary['avg_translation_error_cm']:.4f} cm\n")
        f.write(f"Average Registration Recall: {summary['avg_registration_recall']:.4f}\n")
        f.write(f"Average F1 Score: {summary['avg_f1']:.4f}\n")
    return summary
