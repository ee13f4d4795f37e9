"""3DMatch dataset family: train/val and test pair readers (a copy of the
JAX package's `data/threedmatch.py`, which cannot be imported without jax).

Capability parity with the reference's datasets/ThreeDMatch.py:187-412 (TrainVal)
and :582-777 (Test), as plain-Python datasets (no torch.utils.data dependency —
any loader can wrap them; data/pipeline.py provides a prefetching host loader
that feeds fixed-shape batches to the device).

On-disk contracts (defined by the offline preprocessing,
the reference's data_preprocess/3DMatch_Feature.py:206-214):
  train_3dmatch/*.pkl : torch-tensor dict
      {src_keypts, tgt_keypts, src_features, tgt_features, corr, gt_labels,
       gt_pose}, each with a leading singleton batch dim.
  test_3dmatch/*.pkl  : numpy dict {xyz_0, xyz_1, feat_0, feat_1, corr,
       labels, gt_pose}; FCGF features truncate to [:, :32].
File lists come from {train,val,test}_files.txt at the dataset root.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field

import numpy as np

from ..core import se3_np
from .sampling import SampledPair, sample_pair


def _to_numpy(v):
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def load_train_pkl(path: str) -> dict:
    """Load a train pair pkl → numpy dict with unified keys.

    The reference ecosystem has TWO train schemas: the TrainVal reader
    expects torch-tensor dicts keyed src_keypts/gt_labels
    (the reference's datasets/ThreeDMatch.py:234), while its own
    preprocessor writes numpy dicts keyed xyz_0/labels
    (the reference's data_preprocess/3DMatch_Feature.py:206-214) — the
    shipped reader only loads an earlier data generation. We accept both,
    so archives produced by data/preprocess/threedmatch_cli.py train
    directly."""
    with open(path, "rb") as f:
        try:
            raw = pickle.load(f)
        except Exception:
            import torch
            raw = torch.load(path, map_location="cpu", weights_only=False)
    keymap = [
        ("src_keypts", "src_pts"), ("tgt_keypts", "tgt_pts"),
        ("src_features", "src_feat"), ("tgt_features", "tgt_feat"),
        ("corr", "corr"), ("gt_labels", "labels"), ("gt_pose", "gt_pose"),
    ] if "src_keypts" in raw else [
        ("xyz_0", "src_pts"), ("xyz_1", "tgt_pts"),
        ("feat_0", "src_feat"), ("feat_1", "tgt_feat"),
        ("corr", "corr"), ("labels", "labels"), ("gt_pose", "gt_pose"),
    ]
    out = {}
    for src_key, dst_key in keymap:
        v = _to_numpy(raw[src_key])
        if v.ndim >= 1 and v.shape[0] == 1:
            v = v[0]
        out[dst_key] = v
    return out


def load_test_pkl(path: str, descriptor: str = "fcgf") -> dict:
    with open(path, "rb") as f:
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
class ThreeDMatchPairDataset:
    """Unified 3DMatch reader; split selects file list, subdir and policies.

    split='train'/'val': 70% positive cap, torch-format pkls under
    train_3dmatch/ (reference TrainVal). split='test': 90% cap, numpy pkls
    under test_3dmatch/ (reference Test).
    """
    root: str
    split: str = "train"
    descriptor: str = "fcgf"          # 'fcgf' (32-d) | 'fpfh' (33-d, L2-normed)
    num_node: int = 2048
    inlier_threshold: float = 0.10
    synthetic_pose: bool = False      # off by default (reference :212)
    normalize_to_source: bool = False
    augment_axis: int = 1
    augment_rotation: float = 1.4
    augment_translation: float = 0.1
    seed: int = 0
    legacy_sampling_rng: bool = False  # reference-stream sampling parity: use
                                       # a per-item np.random.RandomState(seed
                                       # + index) — the sampler's choice-call
                                       # sequence mirrors the reference's
                                       # (ThreeDMatch.py:681-706), so seeding
                                       # the reference's GLOBAL np.random with
                                       # seed+index yields IDENTICAL sampled
                                       # indices (pipeline-parity harness)
    _files: list = field(default_factory=list, init=False, repr=False)

    def __post_init__(self):
        assert self.descriptor in ("fpfh", "fcgf")
        assert self.split in ("train", "val", "test")
        list_file = os.path.join(self.root, f"{self.split}_files.txt")
        with open(list_file) as f:
            self._files = [ln.strip() for ln in f if ln.strip()]
        self._rng = np.random.default_rng(self.seed)
        self._subdir = "test_3dmatch" if self.split == "test" else "train_3dmatch"
        self._pos_fraction = 0.90 if self.split == "test" else 0.70

    def __len__(self) -> int:
        return len(self._files)

    def load_raw(self, index: int) -> dict:
        path = os.path.join(self.root, self._subdir, self._files[index])
        if self.split == "test":
            d = load_test_pkl(path, self.descriptor)
        else:
            d = load_train_pkl(path)
        if self.descriptor == "fpfh":
            d["src_feat"] = _l2_normalize_rows(d["src_feat"])
            d["tgt_feat"] = _l2_normalize_rows(d["tgt_feat"])
        return d

    def _item_rng(self, index: int):
        """One definition of the per-item sampling stream (mirrors
        data/kitti.py): legacy mode replays the reference's global-np.random
        convention via RandomState(seed + index)."""
        return (np.random.RandomState(self.seed + index)
                if self.legacy_sampling_rng else self._rng)

    def __getitem__(self, index: int):
        d = self.load_raw(index)
        pair = sample_pair(
            d["src_pts"], d["tgt_pts"], d["src_feat"], d["tgt_feat"],
            d["corr"], d["labels"], d["gt_pose"],
            sample_size=self.num_node, pos_fraction=self._pos_fraction,
            rng=self._item_rng(index))

        if self.synthetic_pose:
            pair = self._synthetic_pose_augment(pair)
        if self.normalize_to_source:
            pair = self._normalize_to_source(pair)
        # reference 7-tuple contract (datasets/ThreeDMatch.py:403-409)
        return (pair.corr, pair.labels, pair.src_pts, pair.tgt_pts,
                pair.src_feat, pair.tgt_feat, pair.gt_pose)

    def _synthetic_pose_augment(self, pair: SampledPair) -> SampledPair:
        """Replace the target with a random rigid transform of the source
        (reference :379-394): perfect correspondences, labels all ones."""
        rng = self._rng
        n = pair.src_pts.shape[0]
        src = pair.src_pts + rng.random((n, 3), dtype=np.float32) * 0.005
        aug = se3_np.random_pose(rng, self.augment_axis, self.augment_rotation,
                                 self.augment_translation)
        tgt = se3_np.transform(src, aug) + rng.random((n, 3), dtype=np.float32) * 0.005
        idx = np.arange(n, dtype=np.float32)[:, None]
        return SampledPair(
            corr=np.hstack([idx, idx]).astype(np.float32),
            labels=np.ones(n, np.float32),
            src_pts=src.astype(np.float32), tgt_pts=tgt.astype(np.float32),
            src_feat=pair.src_feat, tgt_feat=pair.src_feat,
            gt_pose=aug.astype(np.float32))

    def _normalize_to_source(self, pair: SampledPair) -> SampledPair:
        """Center source at origin; bring target into the source frame via the
        GT pose (reference :398-401 semantics)."""
        tgt_in_src = se3_np.transform(pair.tgt_pts, np.linalg.inv(pair.gt_pose))
        centroid = pair.src_pts.mean(axis=0)
        return pair._replace(src_pts=pair.src_pts - centroid,
                             tgt_pts=tgt_in_src.astype(np.float32))


def ThreeDMatchTrainVal(root, split="train", **kw):
    """Reference-named constructor (datasets/ThreeDMatch.py:187)."""
    assert split in ("train", "val")
    return ThreeDMatchPairDataset(root=root, split=split, **kw)


def ThreeDMatchTest(root, split="test", **kw):
    """Reference-named constructor (datasets/ThreeDMatch.py:582)."""
    return ThreeDMatchPairDataset(root=root, split="test", **kw)
