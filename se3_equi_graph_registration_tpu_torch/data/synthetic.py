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


def make_raw_pair(rng: np.random.Generator, n_points: int = 400,
                  feat_dim: int = 32, inlier_ratio: float = 0.55,
                  noise: float = 0.02, extent: float = 1.5,
                  feat_noise: float = 0.1,
                  inlier_threshold: float = 0.10) -> dict:
    """One UNSAMPLED pair in the offline preprocessing's terms
    (the reference's data_preprocess/3DMatch_Feature.py:158-214): full clouds
    xyz_0/xyz_1, per-point descriptors, a putative correspondence list with
    corr[:, 0] == arange (one NN match per source point, :158-166), and
    geometric inlier labels dist(T·src[corr0] − tgt[corr1]) < threshold
    (:199-204). Target rows are a random permutation of the transformed
    source so target indexing is non-trivial."""
    src = rng.uniform(-extent, extent, size=(n_points, 3)).astype(np.float32)
    R = random_rotation(rng).astype(np.float32)
    t = (rng.standard_normal(3) * 0.5).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3], pose[:3, 3] = R, t

    perm = rng.permutation(n_points)
    warped = src @ R.T + t
    tgt = np.empty_like(src)
    tgt[perm] = warped + rng.standard_normal((n_points, 3)).astype(np.float32) * noise

    feat_0 = rng.standard_normal((n_points, feat_dim)).astype(np.float32)
    feat_0 /= np.linalg.norm(feat_0, axis=1, keepdims=True) + 1e-6
    feat_1 = np.empty_like(feat_0)
    feat_1[perm] = feat_0 + rng.standard_normal(
        (n_points, feat_dim)).astype(np.float32) * feat_noise
    feat_1 /= np.linalg.norm(feat_1, axis=1, keepdims=True) + 1e-6

    # correspondence list: inliers match their true counterpart, outliers a
    # mismatched target row (the feature-NN failure mode the labels flag)
    corr1 = perm.copy()
    n_out = int(n_points * (1.0 - inlier_ratio))
    out_rows = rng.choice(n_points, n_out, replace=False)
    corr1[out_rows] = (perm[out_rows]
                       + rng.integers(1, n_points, n_out)) % n_points
    corr = np.stack([np.arange(n_points), corr1], axis=1).astype(np.int64)
    dist = np.linalg.norm(warped - tgt[corr1], axis=1)
    labels = (dist < inlier_threshold).astype(np.float32)
    return {"xyz_0": src, "xyz_1": tgt, "feat_0": feat_0, "feat_1": feat_1,
            "corr": corr, "labels": labels, "gt_pose": pose}


def write_reference_test_archive(root: str, n_pairs: int = 4,
                                 n_points: int = 400, feat_dim: int = 32,
                                 seed: int = 7, **pair_kw) -> list:
    """Write a 3DMatch TEST archive in the reference's exact on-disk schema:
    `test_3dmatch/*.pkl` numpy dicts {xyz_0, xyz_1, feat_0, feat_1, corr,
    labels, gt_pose} plus `test_files.txt` (datasets/ThreeDMatch.py:615-643,
    contract from data_preprocess/3DMatch_Feature.py:363-365). Readable by
    BOTH the imported reference ThreeDMatchTest and this framework's reader —
    the substrate of the pipeline-vs-pipeline parity harness."""
    import os
    import pickle

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "test_3dmatch"), exist_ok=True)
    names = []
    for i in range(n_pairs):
        d = make_raw_pair(rng, n_points, feat_dim, **pair_kw)
        name = f"pair_{i:04d}.pkl"
        with open(os.path.join(root, "test_3dmatch", name), "wb") as f:
            pickle.dump(d, f)
        names.append(name)
    with open(os.path.join(root, "test_files.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return names


def write_reference_kitti_archive(root: str, n_train: int = 3, n_val: int = 1,
                                  n_test: int = 4, n_points: int = 400,
                                  feat_dim: int = 33, seed: int = 13,
                                  **pair_kw) -> dict:
    """Write a KITTI archive in the reference's on-disk schema: PICKLED dicts
    {xyz_0, xyz_1, feat_0, feat_1, corr, labels, gt_pose} under train_kitti/
    and test_kitti/, plus the three file lists. The reference reads them with
    `np.load(f, allow_pickle=True)` INSIDE a closed-on-exit `with` block and
    accesses fields afterwards (datasets/KITTI.py:230-238, :438-452) — that
    only works through np.load's eager pickle fallback, so the files must be
    plain pickles, not real (lazily-read) npz archives. Defaults mirror KITTI
    conditions: 33-d FPFH-like descriptors, LiDAR-scale extent, 0.60 m inlier
    threshold (data_preprocess/process_kitti.py:175)."""
    import os
    import pickle

    rng = np.random.default_rng(seed)
    kw = dict(extent=10.0, noise=0.15, inlier_threshold=0.60)
    kw.update(pair_kw)
    names = {}
    for subdir, count_list in (("train_kitti", [("train", n_train),
                                                ("val", n_val)]),
                               ("test_kitti", [("test", n_test)])):
        os.makedirs(os.path.join(root, subdir), exist_ok=True)
        for split, count in count_list:
            files = []
            for i in range(count):
                d = make_raw_pair(rng, n_points, feat_dim, **kw)
                name = f"{split}_pair_{i:04d}.pkl"
                with open(os.path.join(root, subdir, name), "wb") as f:
                    pickle.dump(d, f)
                files.append(name)
            names[split] = files
            with open(os.path.join(root, f"{split}_files.txt"), "w") as f:
                f.write("\n".join(files) + "\n")
    return names


def write_reference_train_archive(root: str, n_train: int = 4, n_val: int = 2,
                                  n_points: int = 400, feat_dim: int = 32,
                                  seed: int = 7, **pair_kw) -> tuple:
    """Write a 3DMatch TRAIN/VAL archive in the reference's torch-tensor pkl
    schema: `train_3dmatch/*.pkl` dicts {src_keypts, tgt_keypts, src_features,
    tgt_features, corr, gt_labels, gt_pose} with a leading singleton batch dim
    (datasets/ThreeDMatch.py:234-240), plus train_files.txt / val_files.txt."""
    import os
    import pickle

    import torch

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "train_3dmatch"), exist_ok=True)
    names = []
    for i in range(n_train + n_val):
        d = make_raw_pair(rng, n_points, feat_dim, **pair_kw)
        blob = {
            "src_keypts": torch.from_numpy(d["xyz_0"][None]),
            "tgt_keypts": torch.from_numpy(d["xyz_1"][None]),
            "src_features": torch.from_numpy(d["feat_0"][None]),
            "tgt_features": torch.from_numpy(d["feat_1"][None]),
            "corr": torch.from_numpy(d["corr"][None]),
            "gt_labels": torch.from_numpy(d["labels"][None]),
            "gt_pose": torch.from_numpy(d["gt_pose"][None]),
        }
        name = f"pair_{i:04d}.pkl"
        with open(os.path.join(root, "train_3dmatch", name), "wb") as f:
            pickle.dump(blob, f)
        names.append(name)
    train, val = names[:n_train], names[n_train:]
    with open(os.path.join(root, "train_files.txt"), "w") as f:
        f.write("\n".join(train) + "\n")
    with open(os.path.join(root, "val_files.txt"), "w") as f:
        f.write("\n".join(val) + "\n")
    return train, val
