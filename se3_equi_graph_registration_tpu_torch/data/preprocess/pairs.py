"""Offline pair construction: descriptors → correspondences → inlier labels → pkl
(the JAX package's `data/preprocess/pairs.py`, function for function; only
`extract_fpfh` differs, by its `device` keyword).

The open3d-independent core of the reference's preprocessing
(data_preprocess/3DMatch_Feature.py): feature-space nearest-neighbor
correspondences `argmin √(2−2·fᵀf)` (:158-166), inlier labels by GT-warped
distance < threshold (:199-204, 0.10 m for 3DMatch; 0.60 m KITTI test per
process_kitti.py:175), optional jitter + random SE(3) augmentation of the
target (:115-122), and the on-disk pair schema (:206-214).

Descriptor extraction itself (FPFH via open3d, FCGF via its torch checkpoint)
lives in ops/fpfh.py / behind `extract_fpfh`, gated on open3d availability —
the port's images ship without open3d, and the native route computes the
descriptors on the card.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ...core import se3_np


def feature_nn_correspondences(src_feat: np.ndarray, tgt_feat: np.ndarray,
                               block: int = 4096) -> np.ndarray:
    """corr[i] = (i, argmin_j √(2−2·src_iᵀtgt_j)) — blocked so the [N,M]
    similarity never exceeds block·M floats (the reference materializes the
    full matrix)."""
    n = src_feat.shape[0]
    out = np.empty((n, 2), np.int64)
    out[:, 0] = np.arange(n)
    for s in range(0, n, block):
        sim = src_feat[s:s + block] @ tgt_feat.T
        # monotone: argmin of sqrt(2-2*sim) == argmax of sim
        out[s:s + block, 1] = np.argmax(sim, axis=1)
    return out


def inlier_labels(src_pts: np.ndarray, tgt_pts: np.ndarray, corr: np.ndarray,
                  gt_pose: np.ndarray, threshold: float) -> np.ndarray:
    """labels[i] = ‖warp(src[corr_i0]) − tgt[corr_i1]‖ < threshold (:199-204)."""
    warped = se3_np.transform(src_pts[corr[:, 0]], gt_pose)
    d = np.linalg.norm(warped - tgt_pts[corr[:, 1]], axis=1)
    return (d < threshold).astype(np.float32)


def normalize_descriptors(feat: np.ndarray) -> np.ndarray:
    """Row-wise L2 normalization with the reference's +1e-6 denominator —
    applied to FPFH descriptors in every reference branch (:113-118, :300-303;
    the train branch's `np.nan_to_num(features)` discards its return value,
    so it is a no-op there and is NOT reproduced here)."""
    return feat / (np.linalg.norm(feat, axis=1, keepdims=True) + 1e-6)


def augment_target(tgt_pts: np.ndarray, rng: np.random.Generator,
                   augment_axis: int = 3, augment_rotation: float = 1.0,
                   augment_translation: float = 0.5,
                   jitter: float = 0.005) -> tuple[np.ndarray, np.ndarray]:
    """Random SE(3) augmentation of the target cloud; returns (augmented
    points, gt_pose mapping ORIGINAL src frame → augmented tgt frame). The
    reference composes aug ∘ I since src/tgt start aligned (:118-122).
    Draw order matches the reference (jitter, rotation angles, translation)
    so a legacy-seeded rng replays its stream bit-exactly."""
    pts = tgt_pts + rng.random(tgt_pts.shape) * jitter if jitter \
        else tgt_pts
    aug = se3_np.random_pose(rng, augment_axis, augment_rotation,
                             augment_translation)
    return se3_np.transform(pts, aug), \
        se3_np.concatenate(aug, np.eye(4, dtype=np.float32))


def build_pair(src_pts, tgt_pts, src_feat, tgt_feat, gt_pose,
               inlier_threshold: float, file_0: str | None = None,
               file_1: str | None = None) -> dict:
    """Assemble the on-disk pair dict in the reference schema (:206-214,
    :355-365): float32 points, corr int64 (arange/argmin dtype), labels
    int32, gt_pose at its computed (float64) precision, optional file ids —
    so archives written here are byte-compatible drop-ins for reference
    consumers (tests/test_torch_preprocess.py holds them equal to the
    JAX package's)."""
    corr = feature_nn_correspondences(src_feat, tgt_feat)
    labels = inlier_labels(src_pts, tgt_pts, corr, gt_pose, inlier_threshold)
    pair = {
        "xyz_0": np.asarray(src_pts, np.float32),
        "xyz_1": np.asarray(tgt_pts, np.float32),
        "feat_0": np.asarray(src_feat),
        "feat_1": np.asarray(tgt_feat),
        "corr": corr,
        "labels": labels.astype(np.int32),
        "gt_pose": np.asarray(gt_pose),
    }
    if file_0 is not None:
        pair["file_0"] = file_0
    if file_1 is not None:
        pair["file_1"] = file_1
    return pair


def save_pair(path: str, pair: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(pair, f)


def extract_fpfh(points: np.ndarray, voxel_size: float = 0.05,
                 normal_radius_mult: float = 2.0,
                 feature_radius_mult: float = 5.0,
                 backend: str = "auto", device=None):
    """FPFH 33-d descriptors (process_kitti.py:21-38 semantics: voxel
    downsample → normals → FPFH).

    backend: 'open3d' (the reference's extractor), 'native' (the torch
    implementation in ops/fpfh.py, on `device`: the card unless
    device='cpu'), or 'auto' (open3d when importable, else native). The
    native descriptors are a faithful FPFH but not bit-parity with open3d's
    radius-search variant — archives must use ONE backend consistently for
    src and tgt."""
    if backend not in ("auto", "open3d", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "open3d":
        try:
            import open3d  # noqa: F401
            have_o3d = True
        except ImportError:
            have_o3d = False
        if backend == "native" or not have_o3d:
            from ...ops.fpfh import extract_fpfh_native
            return extract_fpfh_native(points, voxel_size=voxel_size,
                                       device=device)
    try:
        import open3d as o3d
    except ImportError as e:
        raise ImportError(
            "FPFH extraction with backend='open3d' needs open3d; use "
            "backend='native' (ops/fpfh.py) or run this offline step on a "
            "host with `pip install open3d`.") from e
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(np.asarray(points, np.float64))
    pcd = pcd.voxel_down_sample(voxel_size)
    pcd.estimate_normals(o3d.geometry.KDTreeSearchParamHybrid(
        radius=voxel_size * normal_radius_mult, max_nn=30))
    fpfh = o3d.pipelines.registration.compute_fpfh_feature(
        pcd, o3d.geometry.KDTreeSearchParamHybrid(
            radius=voxel_size * feature_radius_mult, max_nn=100))
    return np.asarray(pcd.points, np.float32), \
        np.asarray(fpfh.data, np.float32).T
