"""Quickstart: register one point-cloud pair end to end (the port's twin of
the JAX package's `examples/register_pair.py`).

    python -m se3_equi_graph_registration_tpu_torch.examples.register_pair
    python -m se3_equi_graph_registration_tpu_torch.examples.register_pair --pkl pair.pkl
    python -m se3_equi_graph_registration_tpu_torch.examples.register_pair \\
        --checkpoint checkpoint-3dmatch.pth

Runs on the CUDA card (`--device cpu` for the plain PyTorch path). With no
checkpoint the model runs at the engine's seeded random weights: the pose
from random features is meaningless, but the pipeline (k-NN graphs ->
shared EGNN -> weighted Kabsch) is the production one.
"""
from __future__ import annotations

import argparse
import pickle
from typing import Optional

import numpy as np


def load_pair(args, rng):
    """(src, src_feat, tgt, tgt_feat, gt_pose or None) from a 3DMatch test
    pkl, or one synthetic pair of `args.n` correspondences."""
    if args.pkl:
        with open(args.pkl, "rb") as f:
            d = pickle.load(f)
        # 3DMatch test pkl schema (the reference's 3DMatch_Feature.py:206-214)
        corr = np.asarray(d["corr"], np.int64)
        src = np.asarray(d["xyz_0"], np.float32)[corr[:, 0]]
        tgt = np.asarray(d["xyz_1"], np.float32)[corr[:, 1]]
        fs = np.asarray(d["feat_0"], np.float32)[corr[:, 0]][:, :32]
        ft = np.asarray(d["feat_1"], np.float32)[corr[:, 1]][:, :32]
        gt = d.get("gt_pose")
        gt = np.asarray(gt, np.float32) if gt is not None else None
        return src, fs, tgt, ft, gt
    from ..data.synthetic import make_pair_batch
    pb = make_pair_batch(rng, batch=1, n=args.n, feat_dim=32)
    return (pb.src_pts[0], pb.src_feat[0], pb.tgt_pts[0], pb.tgt_feat[0], pb.gt_pose[0])


def registrar(args):
    """The Registrar the flags ask for: a checkpoint's weights, or the
    engine's seeded init at the fast, parity or robust config."""
    import torch

    from ..serving import Registrar
    from ..train import checkpoints, engine

    if args.checkpoint:
        return Registrar.from_checkpoint(args.checkpoint, fast=not args.parity,
                                         robust=args.robust, num_nodes=args.n,
                                         device=args.device)
    base = (engine.robust_eval_config if args.robust
            else engine.EngineConfig if args.parity
            else engine.fast_tpu_config)
    cfg = base(num_nodes=args.n, top_k=128)
    model = engine.build_model(cfg, head_mode="eval_fusion", device="cpu")
    checkpoints.init_weights(model, torch.Generator().manual_seed(0))
    return Registrar(model.state_dict(), cfg, device=args.device)


def register_pair(args) -> dict:
    """Register the pair; {'R', 't', 'similarity_mean', and with a ground
    truth 'rot_err_deg', 'trans_err_cm'}."""
    import torch

    from ..train import metrics

    rng = np.random.default_rng(0)
    src_pts, src_feat, tgt_pts, tgt_feat, gt_pose = load_pair(args, rng)
    reg = registrar(args)
    # unbatched [N, .] inputs -> unbatched R [3,3], t [3]
    R, t, info = reg.register(src_pts, src_feat, tgt_pts, tgt_feat)
    out = {"R": np.asarray(R), "t": np.asarray(t),
           "similarity_mean": float(info["similarity_mean"])}
    if gt_pose is not None:
        pred = np.eye(4, dtype=np.float32)
        pred[:3, :3], pred[:3, 3] = out["R"], out["t"]
        rre, rte = metrics.calculate_pose_error(torch.from_numpy(gt_pose[None]),
                                                torch.from_numpy(pred[None]))
        out["rot_err_deg"], out["trans_err_cm"] = float(rre[0]), float(rte[0])
    return out


def parse_args(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkl", default=None, help="a 3DMatch-format pair pkl")
    ap.add_argument("--checkpoint", default=None,
                    help=".pth (reference) or a TrainCheckpointer directory; seeded random "
                         "init if unset")
    ap.add_argument("--n", type=int, default=1024,
                    help="compiled point count (inputs are padded/sampled)")
    ap.add_argument("--parity", action="store_true",
                    help="exact/svd checkpoint-parity path instead of fast")
    ap.add_argument("--robust", action="store_true",
                    help="sharp weighting + spectral reweighting + IRLS "
                         "(rescues low-inlier pairs)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    return ap.parse_args(argv)


def main(argv: Optional[list] = None) -> dict:
    out = register_pair(parse_args(argv))
    print("R =\n", out["R"].round(4))
    print("t =", out["t"].round(4))
    print("similarity_mean =", out["similarity_mean"])
    if "rot_err_deg" in out:
        print(f"vs GT: rotation error {out['rot_err_deg']:.2f} deg, "
              f"translation error {out['trans_err_cm']:.2f} cm")
    return out


if __name__ == "__main__":
    main()
