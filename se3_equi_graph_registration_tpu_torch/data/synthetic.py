"""Synthetic correspondence-pair generator (a copy of the JAX package's
`data/synthetic.py`, which cannot be imported without jax).

Produces batches with the exact schema of the reference dataset 7-tuple
(the reference's datasets/ThreeDMatch.py:403-409) — (corr, labels, src_pts,
tgt_pts, src_feat, tgt_feat, gt_pose) — from random geometry, for tests and
benchmarks that must run without the (externally hosted) 3DMatch/KITTI data.

Inliers are generated by applying a random SE(3) pose to the source points plus
noise below the inlier threshold; outliers get independent random targets —
mirroring how the offline preprocessing defines labels
(the reference's data_preprocess/3DMatch_Feature.py:199-204).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PairBatch(NamedTuple):
    corr: np.ndarray        # [B, N, 2] float32 (index pairs, remapped)
    labels: np.ndarray      # [B, N] float32 {0, 1}
    src_pts: np.ndarray     # [B, N, 3] float32
    tgt_pts: np.ndarray     # [B, N, 3] float32
    src_feat: np.ndarray    # [B, N, C] float32
    tgt_feat: np.ndarray    # [B, N, C] float32
    gt_pose: np.ndarray     # [B, 4, 4] float32


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """Uniform random rotation via QR of a Gaussian matrix."""
    A = rng.standard_normal((3, 3))
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q


def make_pair_batch(rng: np.random.Generator, batch: int = 2, n: int = 2048,
                    feat_dim: int = 32, inlier_ratio: float = 0.7,
                    noise: float = 0.02, extent: float = 1.5,
                    feat_noise: float = 0.1) -> PairBatch:
    corrs, labels, srcs, tgts, sfeats, tfeats, poses = [], [], [], [], [], [], []
    for _ in range(batch):
        src = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
        R = random_rotation(rng).astype(np.float32)
        t = (rng.standard_normal(3) * 0.5).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3], pose[:3, 3] = R, t

        lab = (rng.uniform(size=n) < inlier_ratio).astype(np.float32)
        tgt = src @ R.T + t + rng.standard_normal((n, 3)).astype(np.float32) * noise
        outlier_tgt = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
        tgt = np.where(lab[:, None] > 0, tgt, outlier_tgt).astype(np.float32)

        f = rng.standard_normal((n, feat_dim)).astype(np.float32)
        f /= np.linalg.norm(f, axis=1, keepdims=True) + 1e-6
        f_tgt = f + rng.standard_normal((n, feat_dim)).astype(np.float32) * feat_noise
        f_out = rng.standard_normal((n, feat_dim)).astype(np.float32)
        f_tgt = np.where(lab[:, None] > 0, f_tgt, f_out)
        f_tgt /= np.linalg.norm(f_tgt, axis=1, keepdims=True) + 1e-6

        idx = np.arange(n, dtype=np.float32)
        corrs.append(np.stack([idx, idx], axis=1))
        labels.append(lab)
        srcs.append(src)
        tgts.append(tgt)
        sfeats.append(f)
        tfeats.append(f_tgt.astype(np.float32))
        poses.append(pose)

    return PairBatch(
        corr=np.stack(corrs), labels=np.stack(labels), src_pts=np.stack(srcs),
        tgt_pts=np.stack(tgts), src_feat=np.stack(sfeats),
        tgt_feat=np.stack(tfeats), gt_pose=np.stack(poses),
    )
