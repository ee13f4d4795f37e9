"""KITTI odometry dataset family, FPFH 33-d descriptors (a copy of the JAX
package's `data/kitti.py`, which cannot be imported without jax).

Capability parity with the reference's datasets/KITTI.py:188-396 (trainVal) and
:399-571 (test). Both splits read numpy-format pair files ({xyz_0, xyz_1,
feat_0, feat_1, corr, labels, gt_pose}); train uses the balanced 70%-positive
sampler, test samples 2048 correspondences from the inlier-labeled set only
(KITTI.py:502-535; the 0.60 m inlier threshold is baked in by preprocessing,
data_preprocess/process_kitti.py:175).
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field

import numpy as np

from .sampling import remap_correspondences, sample_pair


def load_kitti_pair(path: str, descriptor: str = "fpfh") -> dict:
    with open(path, "rb") as f:
        try:
            raw = np.load(f, allow_pickle=True)
            raw = dict(raw) if hasattr(raw, "files") else raw
        except Exception:
            f.seek(0)
            raw = pickle.load(f)
    feat_0, feat_1 = np.asarray(raw["feat_0"]), np.asarray(raw["feat_1"])
    if descriptor == "fcgf":
        feat_0, feat_1 = feat_0[:, :32], feat_1[:, :32]
    return {
        "src_pts": np.asarray(raw["xyz_0"]), "tgt_pts": np.asarray(raw["xyz_1"]),
        "src_feat": feat_0, "tgt_feat": feat_1,
        "corr": np.asarray(raw["corr"]), "labels": np.asarray(raw["labels"]),
        "gt_pose": np.asarray(raw["gt_pose"]),
    }


def _l2_normalize_rows(a: np.ndarray) -> np.ndarray:
    return a / (np.linalg.norm(a, axis=1, keepdims=True) + 1e-6)


@dataclass
class KITTIPairDataset:
    root: str
    split: str = "train"
    descriptor: str = "fpfh"
    num_node: int = 2048
    inlier_threshold: float = 0.60
    seed: int = 0
    legacy_sampling_rng: bool = False  # reference-stream per-item sampling
                                       # (see data/threedmatch.py — same
                                       # RandomState(seed+index) convention)
    _files: list = field(default_factory=list, init=False, repr=False)

    def __post_init__(self):
        assert self.descriptor in ("fpfh", "fcgf")
        assert self.split in ("train", "val", "test")
        with open(os.path.join(self.root, f"{self.split}_files.txt")) as f:
            self._files = [ln.strip() for ln in f if ln.strip()]
        self._rng = np.random.default_rng(self.seed)
        self._subdir = "test_kitti" if self.split == "test" else "train_kitti"

    def __len__(self) -> int:
        return len(self._files)

    def load_raw(self, index: int) -> dict:
        d = load_kitti_pair(
            os.path.join(self.root, self._subdir, self._files[index]),
            self.descriptor)
        if self.descriptor == "fpfh":
            d["src_feat"] = _l2_normalize_rows(d["src_feat"])
            d["tgt_feat"] = _l2_normalize_rows(d["tgt_feat"])
        return d

    def _item_rng(self, index: int):
        return (np.random.RandomState(self.seed + index)
                if self.legacy_sampling_rng else self._rng)

    def __getitem__(self, index: int):
        d = self.load_raw(index)
        if self.split == "test":
            return self._test_item(d, self._item_rng(index))
        pair = sample_pair(
            d["src_pts"], d["tgt_pts"], d["src_feat"], d["tgt_feat"],
            d["corr"], d["labels"], d["gt_pose"],
            sample_size=self.num_node, pos_fraction=0.70,
            rng=self._item_rng(index))
        return (pair.corr, pair.labels, pair.src_pts, pair.tgt_pts,
                pair.src_feat, pair.tgt_feat, pair.gt_pose)

    def _test_item(self, d: dict, rng):
        """Inlier-only sampling (KITTI.py:499-535): gather the target side
        through corr[:,1], keep label==1 rows, draw exactly num_node."""
        labels = np.asarray(d["labels"]).reshape(-1)
        corr = np.asarray(d["corr"])
        tgt_idx = corr[:, 1].astype(np.int64)
        tgt_pts = np.asarray(d["tgt_pts"])[tgt_idx]
        tgt_feat = np.asarray(d["tgt_feat"])[tgt_idx]

        valid = np.flatnonzero(labels == 1)
        if len(valid) == 0:
            valid = np.arange(len(labels))
        replace = len(valid) < self.num_node
        pick = rng.choice(valid, self.num_node, replace=replace)

        return (remap_correspondences(corr[pick]).astype(np.float32),
                labels[pick].astype(np.float32),
                np.asarray(d["src_pts"])[pick].astype(np.float32),
                tgt_pts[pick].astype(np.float32),
                np.asarray(d["src_feat"])[pick].astype(np.float32),
                tgt_feat[pick].astype(np.float32),
                np.asarray(d["gt_pose"]).astype(np.float32).reshape(4, 4))


def KITTItrainVal(root, split="train", **kw):
    assert split in ("train", "val")
    return KITTIPairDataset(root=root, split=split, **kw)


def KITTItest(root, split="test", **kw):
    return KITTIPairDataset(root=root, split="test", **kw)
