"""Redwood / Augmented ICL-NUIM evaluation dataset (a copy of the JAX
package's `data/redwood.py`, which cannot be imported without jax).

Capability parity with the reference's dataloaders/Redwood.py: builds GT
pairwise transforms from per-fragment poses (pose_j⁻¹ @ pose_i, :60-73),
optional overlap filtering with on-disk caching (:78-110), feature-space
(mutual) nearest-neighbor correspondence construction and PointDSC-style
6-tuple output with centered `corr_pos` concat (:166-203).

No interactive scene prompt (the reference blocks on input() — a script
artifact); `select_scene` is required or all scenes are concatenated.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field

import numpy as np

from ..core import se3_np

SCENES = (
    "livingroom1-simulated",
    "livingroom2-simulated",
    "office1-simulated",
    "office2-simulated",
)


def mutual_nn_correspondences(src_feat: np.ndarray, tgt_feat: np.ndarray,
                              use_mutual: bool = True) -> np.ndarray:
    """Feature-space NN correspondences; distance √(2−2·fᵀf) assumes
    L2-normalized descriptors (Redwood.py:166-174; same formula as
    3DMatch_Feature.py:158-166)."""
    distance = np.sqrt(np.maximum(2.0 - 2.0 * (src_feat @ tgt_feat.T), 0.0) + 1e-6)
    source_idx = np.argmin(distance, axis=1)
    if use_mutual:
        target_idx = np.argmin(distance, axis=0)
        mutual = target_idx[source_idx] == np.arange(source_idx.shape[0])
        return np.stack([np.flatnonzero(mutual), source_idx[mutual]], axis=1)
    return np.stack([np.arange(source_idx.shape[0]), source_idx], axis=1)


@dataclass
class RedwoodDataset:
    root: str
    descriptor: str = "fpfh"
    min_overlap: float = 0.30
    inlier_threshold: float = 0.10
    num_node: int | str = 5000
    use_mutual: bool = True
    select_scene: str | None = None
    seed: int = 0
    compute_overlap: bool = False   # expensive O(N²) pass, cached to pkl
    _pairs: list = field(default_factory=list, init=False, repr=False)

    def __post_init__(self):
        assert self.descriptor in ("fcgf", "fpfh")
        scenes = [self.select_scene] if self.select_scene else list(SCENES)
        self._rng = np.random.default_rng(self.seed)
        self.gt_trans: dict[str, np.ndarray] = {}
        self.gt_trajectory: dict[str, list[np.ndarray]] = {}
        for scene in scenes:
            frag_dir = os.path.join(self.root, scene, "fragments")
            npzs = [f for f in os.listdir(frag_dir) if f.endswith("npz")]
            num = max(int(f.split("_")[1]) for f in npzs) + 1
            poses = [np.load(os.path.join(frag_dir, f"fragment_{i:03d}.npy"))
                     for i in range(num)]
            self.gt_trajectory[scene] = poses
            for i in range(num):
                for j in range(i + 1, num):
                    # src -> world -> tgt
                    self.gt_trans[f"{scene}@{i}_{j}"] = np.linalg.inv(poses[j]) @ poses[i]
        if self.compute_overlap:
            self._filter_by_overlap(scenes)
        self._pairs = sorted(
            self.gt_trans.keys(),
            key=lambda k: (k.split("@")[0],
                           int(k.split("@")[1].split("_")[0]),
                           int(k.split("@")[1].split("_")[1])))

    def _fragment(self, scene: str, idx: int) -> tuple[np.ndarray, np.ndarray]:
        path = os.path.join(self.root, scene, "fragments",
                            f"fragment_{idx:03d}_{self.descriptor}.npz")
        d = np.load(path)
        feat = d["feature"]
        if self.descriptor == "fpfh":
            feat = feat / (np.linalg.norm(feat, axis=1, keepdims=True) + 1e-6)
        return d["xyz"], feat

    def _filter_by_overlap(self, scenes):
        for scene in scenes:
            cache = os.path.join(self.root, f"{scene}-overlap.pkl")
            if os.path.exists(cache):
                with open(cache, "rb") as f:
                    overlap = pickle.load(f)
            else:
                overlap = {}
                keys = [k for k in self.gt_trans if k.startswith(scene + "@")]
                for key in keys:
                    i, j = map(int, key.split("@")[1].split("_"))
                    xyz_i, _ = self._fragment(scene, i)
                    xyz_j, _ = self._fragment(scene, j)
                    warp = se3_np.transform(xyz_i, self.gt_trans[key])
                    d = np.linalg.norm(warp[None] - xyz_j[:, None], axis=-1)
                    ov = max(float((d.min(0) < self.inlier_threshold).mean()),
                             float((d.min(1) < self.inlier_threshold).mean()))
                    overlap[key] = ov
                with open(cache, "wb") as f:
                    pickle.dump(overlap, f)
            for k, v in overlap.items():
                if v < self.min_overlap and k in self.gt_trans:
                    self.gt_trans.pop(k)

    def __len__(self) -> int:
        return len(self._pairs)

    def __getitem__(self, index: int):
        key = self._pairs[index]
        scene, ids = key.split("@")
        i, j = map(int, ids.split("_"))
        src_xyz, src_feat = self._fragment(scene, i)
        tgt_xyz, tgt_feat = self._fragment(scene, j)

        if self.num_node != "all":
            if src_xyz.shape[0] > self.num_node:
                sel = self._rng.choice(src_xyz.shape[0], self.num_node, replace=False)
                src_xyz, src_feat = src_xyz[sel], src_feat[sel]
            if tgt_xyz.shape[0] > self.num_node:
                sel = self._rng.choice(tgt_xyz.shape[0], self.num_node, replace=False)
                tgt_xyz, tgt_feat = tgt_xyz[sel], tgt_feat[sel]

        corr = mutual_nn_correspondences(src_feat, tgt_feat, self.use_mutual)
        gt_trans = self.gt_trans[key]

        frag1 = src_xyz[corr[:, 0]]
        frag2 = tgt_xyz[corr[:, 1]]
        dist = np.linalg.norm(se3_np.transform(frag1, gt_trans) - frag2, axis=1)
        labels = (dist < self.inlier_threshold).astype(np.float32)

        corr_pos = np.concatenate([frag1, frag2], axis=-1)
        corr_pos = corr_pos - corr_pos.mean(0)

        return (corr_pos.astype(np.float32), frag1.astype(np.float32),
                frag2.astype(np.float32), gt_trans.astype(np.float32),
                labels, key)
