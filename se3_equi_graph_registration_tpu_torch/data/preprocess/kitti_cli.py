"""KITTI odometry preprocessing CLI (the JAX package's
`data/preprocess/kitti_cli.py`, function for function; `process_archives`,
`make_sequence_pairs` and `main` differ only by a `device`, which the
default FPFH extractor runs on: the card unless device='cpu').

Capability parity with the reference's data_preprocess/process_kitti.py:
sequential LiDAR frames → FPFH descriptors (extract_fpfh via open3d,
:21-38, else the port's native FPFH) → GT relative poses from the odometry
poses file → feature-NN correspondences → inlier labels at 0.60 m (:175) →
per-pair pkl files.

  python -m se3_equi_graph_registration_tpu_torch.data.preprocess.kitti_cli \
      VELODYNE_DIR POSES_FILE OUT_DIR [--frame-step 10] [--device cpu]
  python -m se3_equi_graph_registration_tpu_torch.data.preprocess.kitti_cli \
      --archives ARCHIVE_DIR OUT_DIR [--split test] [--descriptor fcgf|fpfh]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ...core import se3_np
from . import pairs

INLIER_THRESHOLD = 0.60  # meters (reference :175)


def process_archives(data_dir: str, out_dir: str, split: str = "test",
                     descriptor: str = "fcgf",
                     inlier_threshold: float | None = None,
                     augment_axis: int = 0, augment_rotation: float = 0.0,
                     augment_translation: float = 0.0,
                     use_mutual: bool = False, voxel_size: float = 0.025,
                     legacy_rng: bool = False, seed: int | None = None,
                     feature_extractor=None, device=None) -> int:
    """Process FCGF-style pair archives (.npz with keys xyz0/xyz1/features0/
    features1/gt_trans) into the reference pkl pair schema — the stage
    the reference's data_preprocess/process_kitti.py:165-269 runs as shipped
    (test constants: no jitter, identity augment, 0.60 m labels :175) and its
    commented train branch :49-163 runs at split='train' constants (0.05
    jitter on BOTH clouds :86-87, augment_axis 3 / rot 1.0 / trans 0.5
    :56-58, 0.10 m labels :59).

    descriptor='fpfh' re-extracts descriptors from the raw keypoints
    (`feature_extractor(pts, voxel_size) -> (pts, feats)`, default
    pairs.extract_fpfh — open3d-or-native, the native route on `device`)
    and L2-normalizes them with the
    reference's +1e-6 denominator (:192-196); 'fcgf' keeps the archive
    features as-is. `legacy_rng=True` draws jitter/augment through the
    global np.random stream in the reference's order (jitter src, jitter
    tgt, rotation angles, translation) so a np.random.seed()-seeded run
    replays the reference bit-exactly. Labels are int64 — process_kitti's
    `.astype(int)` (:249), unlike 3DMatch's int32. Output: one
    `<stem>.pkl` per archive (the reference numbers by listdir order;
    `file_0`/`file_1` carry the archive basename either way :251-252).
    """
    from .threedmatch_cli import _LegacyRandom
    if split not in ("train", "test"):
        raise ValueError(f"split must be 'train' or 'test', got {split!r}")
    if inlier_threshold is None:
        inlier_threshold = 0.10 if split == "train" else INLIER_THRESHOLD
    rng = _LegacyRandom() if legacy_rng else np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for fname in sorted(f for f in os.listdir(data_dir)
                        if f.endswith(".npz")):
        data = np.load(os.path.join(data_dir, fname))
        src_keypts, tgt_keypts = data["xyz0"], data["xyz1"]
        src_feat, tgt_feat = data["features0"], data["features1"]
        if descriptor == "fpfh":
            extract = feature_extractor or (
                lambda p, v: pairs.extract_fpfh(p, voxel_size=v, device=device))
            src_keypts, src_feat = extract(src_keypts, voxel_size)
            tgt_keypts, tgt_feat = extract(tgt_keypts, voxel_size)
            src_feat = pairs.normalize_descriptors(src_feat)
            tgt_feat = pairs.normalize_descriptors(tgt_feat)
        orig_trans = data["gt_trans"]
        if split == "train":
            src_keypts = src_keypts + rng.random(src_keypts.shape) * 0.05
            tgt_keypts = tgt_keypts + rng.random(tgt_keypts.shape) * 0.05
        # identical draw order either way: rotation angles then translation
        # (translation_matrix draws even at magnitude 0.0, like :204-205)
        aug = se3_np.random_pose(rng, augment_axis, augment_rotation,
                                 augment_translation)
        tgt_keypts = se3_np.transform(tgt_keypts, aug)
        gt_pose = se3_np.concatenate(aug, orig_trans)
        corr = pairs.feature_nn_correspondences(src_feat, tgt_feat)
        if use_mutual:
            # reference :235-240: keep reciprocal matches only
            back = pairs.feature_nn_correspondences(tgt_feat, src_feat)[:, 1]
            corr = corr[back[corr[:, 1]] == corr[:, 0]]
        labels = pairs.inlier_labels(src_keypts, tgt_keypts, corr, gt_pose,
                                     inlier_threshold).astype(np.int64)
        result = {
            "file_0": fname, "file_1": fname,
            "xyz_0": np.asarray(src_keypts, np.float32),
            "xyz_1": np.asarray(tgt_keypts, np.float32),
            "feat_0": np.asarray(src_feat),
            "feat_1": np.asarray(tgt_feat),
            "corr": corr, "labels": labels, "gt_pose": np.asarray(gt_pose),
        }
        with open(os.path.join(out_dir, fname[:-4] + ".pkl"), "wb") as f:
            pickle.dump(result, f, pickle.HIGHEST_PROTOCOL)
        count += 1
    return count


def load_kitti_poses(path: str) -> np.ndarray:
    """KITTI odometry poses file: one 3x4 row-major matrix per line → [N,4,4]."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4, dtype=np.float64), (len(rows), 1, 1))
    out[:, :3, :4] = rows
    return out


def load_velodyne_bin(path: str) -> np.ndarray:
    """KITTI .bin scan: float32 x,y,z,reflectance → [N,3]."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return pts[:, :3]


def make_sequence_pairs(velodyne_dir: str, poses_file: str, out_dir: str,
                        frame_step: int = 10, voxel_size: float = 0.30,
                        max_pairs: int | None = None, device=None) -> int:
    """Pairs of frames `frame_step` apart with GT relative pose
    inv(pose_j) @ pose_i (src frame i → tgt frame j); FPFH by
    pairs.extract_fpfh, the native route on `device`."""
    poses = load_kitti_poses(poses_file)
    scans = sorted(f for f in os.listdir(velodyne_dir) if f.endswith(".bin"))
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for i in range(0, len(scans) - frame_step, frame_step):
        j = i + frame_step
        src_raw = load_velodyne_bin(os.path.join(velodyne_dir, scans[i]))
        tgt_raw = load_velodyne_bin(os.path.join(velodyne_dir, scans[j]))
        src_xyz, src_feat = pairs.extract_fpfh(src_raw, voxel_size=voxel_size,
                                               device=device)
        tgt_xyz, tgt_feat = pairs.extract_fpfh(tgt_raw, voxel_size=voxel_size,
                                               device=device)
        # the reference L2-normalizes FPFH after extraction (:196-197)
        src_feat = pairs.normalize_descriptors(src_feat)
        tgt_feat = pairs.normalize_descriptors(tgt_feat)
        gt_pose = (np.linalg.inv(poses[j]) @ poses[i]).astype(np.float32)
        pair = pairs.build_pair(src_xyz, tgt_xyz, src_feat, tgt_feat, gt_pose,
                                INLIER_THRESHOLD)
        pairs.save_pair(os.path.join(out_dir, f"pair_{i:06d}_{j:06d}.pkl"), pair)
        count += 1
        if max_pairs is not None and count >= max_pairs:
            break
    return count


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("velodyne_dir",
                    help="velodyne scan dir, or (--archives) a dir of "
                         "FCGF-style .npz pair archives")
    ap.add_argument("poses_file", nargs="?", default=None,
                    help="KITTI odometry poses file (unused with --archives)")
    ap.add_argument("out_dir")
    ap.add_argument("--frame-step", type=int, default=10)
    ap.add_argument("--voxel-size", type=float, default=0.30)
    ap.add_argument("--max-pairs", type=int, default=None)
    ap.add_argument("--archives", action="store_true",
                    help="process .npz pair archives through the reference's "
                         "label/augment stage (process_kitti.py) instead of "
                         "building pairs from raw scans")
    ap.add_argument("--split", default="test", choices=("train", "test"))
    ap.add_argument("--descriptor", default="fcgf", choices=("fcgf", "fpfh"))
    ap.add_argument("--device", default=None,
                    help="where the native FPFH runs (default: the CUDA card; "
                         "'cpu' for the CPU)")
    args = ap.parse_args()
    if args.archives:
        kw = ({} if args.split == "test" else
              dict(augment_axis=3, augment_rotation=1.0,
                   augment_translation=0.5))
        n = process_archives(args.velodyne_dir, args.out_dir,
                             split=args.split, descriptor=args.descriptor,
                             device=args.device, **kw)
    else:
        if args.poses_file is None:
            ap.error("poses_file is required without --archives")
        n = make_sequence_pairs(args.velodyne_dir, args.poses_file,
                                args.out_dir, args.frame_step,
                                args.voxel_size, args.max_pairs,
                                device=args.device)
    print(f"wrote {n} pairs")


if __name__ == "__main__":
    main()
