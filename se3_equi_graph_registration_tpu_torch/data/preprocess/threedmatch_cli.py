"""3DMatch offline preprocessing CLI (a copy of the JAX package's
`data/preprocess/threedmatch_cli.py`, which cannot be imported without jax;
numpy only, so it runs on the host).

Capability parity with the reference's data_preprocess/3DMatch_Feature.py:
turn per-fragment descriptor .npz files (FCGF or FPFH, keys xyz + feature)
into the per-pair .pkl contract consumed by the dataset layer.

train mode (:39-233): overlap-filtered pair list → optional jitter + random
SE(3) augmentation of the target (axis 3, rot 1.0, trans 0.5) → feature-NN
correspondences → inlier labels at 0.10 m → pkl.
test mode (:241-365): the 8 standard scenes, gt.log inverse poses, no augment.

Descriptor extraction itself needs open3d/FCGF on a workstation — this CLI
consumes their .npz outputs (same as the reference).

  python -m se3_equi_graph_registration_tpu_torch.data.preprocess.threedmatch_cli \
      train FRAGMENT_DIR PAIR_LIST OUT_DIR [--descriptor fcgf|fpfh|raw]
  python -m se3_equi_graph_registration_tpu_torch.data.preprocess.threedmatch_cli \
      test ROOT OUT_DIR [--descriptor fpfh]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ...core import se3_np
from ...utils.trajectory import read_trajectory_log
from . import pairs

TEST_SCENES = (
    "7-scenes-redkitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30",
    "sun3d-hotel_uc-scan3",
    "sun3d-hotel_umd-maryland_hotel1",
    "sun3d-hotel_umd-maryland_hotel3",
    "sun3d-mit_76_studyroom-76-1studyroom2",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika",
)

INLIER_THRESHOLD = 0.10  # meters (reference :63, :260)


class _LegacyRandom:
    """np.random.Generator facade over the legacy global np.random stream —
    seeding np.random.seed(s) and drawing through this adapter replays the
    reference preprocessor's jitter/rotation/translation draws bit-exactly
    (rand(n)·h and uniform(0,h,n) are the same underlying draw and the same
    fp product)."""

    def random(self, size=None):
        return np.random.random_sample(size)

    def uniform(self, low=0.0, high=1.0, size=None):
        return np.random.uniform(low, high, size)

    def integers(self, low, high):
        return np.random.randint(low, high)

    def standard_normal(self, size=None):
        return np.random.standard_normal(size)


def _load_fragment(path: str, descriptor: str = "raw"
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Load a fragment .npz. A per-descriptor file (`<stem>_fcgf.npz` /
    `<stem>_fpfh.npz` — the reference's on-disk naming, :93-96, :291-294) is
    preferred when present; FPFH descriptors are L2-normalized like every
    reference branch (:113-118, :300-303)."""
    if descriptor in ("fcgf", "fpfh"):
        suffixed = path.replace(".npz", f"_{descriptor}.npz")
        if os.path.exists(suffixed):
            path = suffixed
    d = np.load(path)
    xyz_key = "xyz" if "xyz" in d else "pcd"
    feat_key = "feature" if "feature" in d else "feat"
    xyz, feat = np.asarray(d[xyz_key]), np.asarray(d[feat_key])
    if descriptor == "fpfh":
        feat = pairs.normalize_descriptors(feat)
    return xyz, feat


def make_training_pairs(fragment_dir: str, pair_list_file: str, out_dir: str,
                        jitter: float = 0.005, augment: bool = True,
                        seed: int = 0, descriptor: str = "fcgf",
                        legacy_rng: bool = False,
                        random_swap: bool = False) -> int:
    """pair_list_file lines: `<frag_a.npz> <frag_b.npz> [overlap]`.

    Reference train-branch semantics (:83-233): optional 50% src/tgt swap
    (`random_swap`, drawn from python `random` like the reference :85-86),
    jitter BOTH clouds by rand·0.005, SE(3)-augment the target (axis 3,
    rot 1.0, trans 0.5), feature-NN corr, labels at 0.10 m. With
    `legacy_rng=True` the draws replay the reference's global np.random
    stream (seed with np.random.seed / random.seed before calling);
    otherwise an isolated np.random.Generator(seed) is used.
    """
    import random as pyrandom

    rng = _LegacyRandom() if legacy_rng else np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    with open(pair_list_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            src_id, tgt_id = parts[0], parts[1]
            if random_swap and pyrandom.random() > 0.5:   # reference :85-86
                src_id, tgt_id = tgt_id, src_id
            src_xyz, src_feat = _load_fragment(
                os.path.join(fragment_dir, src_id), descriptor)
            tgt_xyz, tgt_feat = _load_fragment(
                os.path.join(fragment_dir, tgt_id), descriptor)
            if jitter:
                src_xyz = src_xyz + rng.random(src_xyz.shape) * jitter
            if augment:
                tgt_xyz, gt_pose = pairs.augment_target(
                    tgt_xyz, rng, augment_axis=3, augment_rotation=1.0,
                    augment_translation=0.5, jitter=jitter)
            else:
                gt_pose = np.eye(4, dtype=np.float32)
            pair = pairs.build_pair(src_xyz, tgt_xyz, src_feat, tgt_feat,
                                    gt_pose, INLIER_THRESHOLD,
                                    file_0=os.path.basename(src_id),
                                    file_1=os.path.basename(tgt_id))
            name = f"{os.path.splitext(src_id)[0]}@{os.path.splitext(tgt_id)[0]}.pkl"
            pairs.save_pair(os.path.join(out_dir, name.replace('/', '_')), pair)
            count += 1
    return count


def make_test_pairs(root: str, out_dir: str, scenes=TEST_SCENES,
                    descriptor: str = "fpfh") -> int:
    """Per scene: read gt.log, build pairs with orig_trans = inv(gt) (:306).
    The reference test branch is fully deterministic (augment 0, num_node
    'all'), so no rng is involved."""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for scene in scenes:
        gt = read_trajectory_log(
            os.path.join(root, "gt_result", f"{scene}-evaluation", "gt.log"))
        for key, trans in gt.items():
            a, b = key.split("_")
            try:
                src_xyz, src_feat = _load_fragment(
                    os.path.join(root, "fragments", scene,
                                 f"cloud_bin_{a}.npz"), descriptor)
                tgt_xyz, tgt_feat = _load_fragment(
                    os.path.join(root, "fragments", scene,
                                 f"cloud_bin_{b}.npz"), descriptor)
            except FileNotFoundError:
                continue
            gt_pose = np.linalg.inv(trans)
            pair = pairs.build_pair(src_xyz, tgt_xyz, src_feat, tgt_feat,
                                    gt_pose, INLIER_THRESHOLD,
                                    file_0=f"{scene}_{a}",
                                    file_1=f"{scene}_{b}")
            pairs.save_pair(os.path.join(out_dir, f"{scene}@{key}.pkl"), pair)
            count += 1
    return count


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="mode", required=True)
    tr = sub.add_parser("train")
    tr.add_argument("fragment_dir")
    tr.add_argument("pair_list")
    tr.add_argument("out_dir")
    tr.add_argument("--no-augment", action="store_true")
    tr.add_argument("--descriptor", default="fcgf",
                    choices=("fcgf", "fpfh", "raw"))
    te = sub.add_parser("test")
    te.add_argument("root")
    te.add_argument("out_dir")
    te.add_argument("--descriptor", default="fpfh",
                    choices=("fcgf", "fpfh", "raw"))
    args = ap.parse_args()
    if args.mode == "train":
        n = make_training_pairs(args.fragment_dir, args.pair_list, args.out_dir,
                                augment=not args.no_augment,
                                descriptor=args.descriptor)
    else:
        n = make_test_pairs(args.root, args.out_dir,
                            descriptor=args.descriptor)
    print(f"wrote {n} pairs")


if __name__ == "__main__":
    main()
