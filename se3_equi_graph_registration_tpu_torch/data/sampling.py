"""Correspondence sampling (a copy of the JAX package's `data/sampling.py`,
which cannot be imported without jax): the host-side shim onto fixed shapes.

Reference semantics (verified against the reference's datasets/ThreeDMatch.py
:296-369 and the reference's datasets/KITTI.py:499-535), with explicit
`np.random.Generator` state instead of the global numpy RNG.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


def fit_to_count(arr: np.ndarray, n: int, rng: np.random.Generator
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Sample down (without replacement) or pad (repeat with replacement) the
    leading axis to exactly `n` rows; returns (fitted array, row indices).
    The shared host-side shim onto compiled fixed shapes — used by
    serving.Registrar and registration.register_fpfh."""
    cur = arr.shape[0]
    if cur == n:
        return arr, np.arange(n)
    if cur > n:
        idx = rng.choice(cur, n, replace=False)
    else:
        idx = np.concatenate([np.arange(cur),
                              rng.choice(cur, n - cur, replace=True)])
    return arr[idx], idx


def balanced_sample(labels: np.ndarray, sample_size: int, pos_fraction: float,
                    rng: np.random.Generator) -> np.ndarray:
    """Balanced positive/negative index sampling, sorted ascending.

    Cap positives at `pos_fraction`·sample_size (70% train, 90% test in the
    reference); fill the remainder with negatives drawn WITH replacement.
    If positives are scarce, keep them all.
    """
    labels = np.asarray(labels).reshape(-1)
    pos = np.flatnonzero(labels == 1)
    neg = np.flatnonzero(labels == 0)
    pos_cap = int(sample_size * pos_fraction)

    if len(pos) < pos_cap:
        pos_sampled = pos
        need_neg = max(sample_size - len(pos), 0)
    else:
        pos_sampled = rng.choice(pos, pos_cap, replace=False)
        need_neg = sample_size - pos_cap

    if need_neg > 0:
        if len(neg) == 0:  # degenerate: all-inlier pair — pad with positives
            neg_sampled = rng.choice(pos, need_neg, replace=True)
        else:
            neg_sampled = rng.choice(neg, need_neg, replace=True)
        idx = np.concatenate([pos_sampled, neg_sampled])
    else:
        idx = pos_sampled
    return np.sort(idx)


def inlier_only_sample(labels: np.ndarray, sample_size: int,
                       rng: np.random.Generator) -> np.ndarray:
    """KITTI-test policy: sample only label==1 correspondences, with
    replacement if fewer than `sample_size` exist (KITTI.py:521-528).
    Returns indices into the VALID subset's parent array."""
    valid = np.flatnonzero(np.asarray(labels).reshape(-1) == 1)
    if len(valid) == 0:
        raise ValueError("pair has no inlier correspondences")
    replace = len(valid) < sample_size
    return rng.choice(valid, sample_size, replace=replace)


def remap_correspondences(corr: np.ndarray) -> np.ndarray:
    """Remap a sampled [M, 2] correspondence list to dense per-side indices
    (ThreeDMatch.py:352-365)."""
    corr = np.asarray(corr)
    out = np.empty_like(corr)
    for col in range(2):
        uniq, inverse = np.unique(corr[:, col], return_inverse=True)
        out[:, col] = inverse
    return out


class SampledPair(NamedTuple):
    corr: np.ndarray        # [S, 2] remapped
    labels: np.ndarray      # [S]
    src_pts: np.ndarray     # [S, 3]
    tgt_pts: np.ndarray     # [S, 3]
    src_feat: np.ndarray    # [S, C]
    tgt_feat: np.ndarray    # [S, C]
    gt_pose: np.ndarray     # [4, 4]


def sample_pair(src_pts, tgt_pts, src_feat, tgt_feat, corr, labels, gt_pose,
                sample_size: int, pos_fraction: float,
                rng: np.random.Generator) -> SampledPair:
    """Full reference sampling pipeline for one pair: balanced index choice,
    gather target side through corr[:, 1], correspondence remap."""
    idx = balanced_sample(labels, sample_size, pos_fraction, rng)
    s_corr = np.asarray(corr)[idx]
    tgt_idx = s_corr[:, 1].astype(np.int64)
    return SampledPair(
        corr=remap_correspondences(s_corr).astype(np.float32),
        labels=np.asarray(labels)[idx].astype(np.float32),
        src_pts=np.asarray(src_pts)[idx].astype(np.float32),
        tgt_pts=np.asarray(tgt_pts)[tgt_idx].astype(np.float32),
        src_feat=np.asarray(src_feat)[idx].astype(np.float32),
        tgt_feat=np.asarray(tgt_feat)[tgt_idx].astype(np.float32),
        gt_pose=np.asarray(gt_pose).astype(np.float32).reshape(4, 4),
    )
