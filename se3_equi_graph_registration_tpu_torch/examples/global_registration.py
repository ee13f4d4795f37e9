"""Quickstart: register two RAW point clouds with no learned model (the
port's twin of the JAX package's `examples/global_registration.py`):
FPFH-33 descriptors, mutual feature matching, spectral consistency, IRLS
and trimmed point-to-plane ICP (`registration.register_fpfh`).

    python -m se3_equi_graph_registration_tpu_torch.examples.global_registration
    python -m se3_equi_graph_registration_tpu_torch.examples.global_registration \\
        --npz pair.npz           # your clouds (keys: src, tgt)
    python -m se3_equi_graph_registration_tpu_torch.examples.global_registration \\
        --overlap 0.4            # harder: 40% overlap

Runs on the CUDA card (`--device cpu` for the plain PyTorch path). With
--overlap below 0.6 the script also asks for overlap-trimmed ICP with the
trim found automatically (printed): most source points have no counterpart
there, which corrupts the default adaptive trim scale.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np


def make_surfaces(rng, n, overlap):
    """Two independent samplings of a bumpy height field, the second one
    rigidly moved; `overlap` is the shared fraction of the x-extent."""
    centers = rng.uniform(-1.6, 1.6, (30, 2))
    amps = rng.uniform(-0.35, 0.35, 30)
    widths = rng.uniform(0.08, 0.3, 30)

    def surf(n_pts, x0, x1):
        xy = np.stack([rng.uniform(x0, x1, n_pts), rng.uniform(-1, 1, n_pts)], -1)
        z = np.zeros(n_pts)
        for (cx, cy), a, w in zip(centers, amps, widths):
            z += a * np.exp(-((xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2) / w)
        pts = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
        return pts + rng.standard_normal(pts.shape).astype(np.float32) * 0.002

    from ..data.synthetic import random_rotation
    R = random_rotation(rng).astype(np.float32)
    t = (rng.standard_normal(3) * 0.3).astype(np.float32)
    shift = 2.0 * (1.0 - overlap)          # slide the target window along x
    src = surf(n, -1.0, 1.0)
    tgt = surf(n, -1.0 + shift, 1.0 + shift) @ R.T + t
    return src, tgt, R, t


def partial_overlap_knobs(overlap: float) -> dict:
    """The script's knobs below 60% overlap: trimmed ICP with the trim found
    by the TrICP objective, and fewer, surer matches."""
    return dict(top_m=256, icp_trim="auto", icp_iters=20) if overlap < 0.6 else {}


def global_registration(args, **fpfh_knobs) -> dict:
    """Register the pair; {'R', 't', 'pose_covariance', 'knobs', and for the
    synthetic pair 'rot_err_deg', 'trans_err_cm'}. `fpfh_knobs` go to
    `register_fpfh` beside the partial-overlap ones (e.g. the fused k-NN:
    knn_method='fused', knn_packed='chunked')."""
    from ..registration import register_fpfh

    rng = np.random.default_rng(0)
    gt = None
    if args.npz:
        d = np.load(args.npz)
        src, tgt = np.asarray(d["src"], np.float32), np.asarray(d["tgt"], np.float32)
    else:
        src, tgt, R_gt, t_gt = make_surfaces(rng, args.n_points, args.overlap)
        gt = (R_gt, t_gt)
    kw = partial_overlap_knobs(args.overlap)
    R, t, info = register_fpfh(src, tgt, n_points=args.n_points, voxel=args.voxel,
                               device=args.device, **kw, **fpfh_knobs)
    out = {"R": R, "t": t, "pose_covariance": info["pose_covariance"], "knobs": kw}
    if gt is not None:
        d = np.linalg.norm(R - gt[0]) / np.sqrt(2.0)
        out["rot_err_deg"] = float(np.degrees(2.0 * np.arcsin(np.clip(d / 2.0, 0.0, 1.0))))
        out["trans_err_cm"] = float(np.linalg.norm(t - gt[1]) * 100)
    return out


def parse_args(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--npz", help="npz with 'src' and 'tgt' [N, 3] arrays")
    ap.add_argument("--n-points", type=int, default=1024)
    ap.add_argument("--overlap", type=float, default=1.0,
                    help="synthetic only: shared fraction of the surfaces")
    ap.add_argument("--voxel", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    return ap.parse_args(argv)


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    knobs = partial_overlap_knobs(args.overlap)
    if knobs:
        print(f"partial-overlap settings: {knobs}")
    out = global_registration(args)
    print("R =\n", np.round(out["R"], 4))
    print("t =", np.round(out["t"], 4))
    print("pose sigma (rot axes, deg):",
          np.round(np.degrees(np.sqrt(np.diag(out["pose_covariance"])[:3])), 4))
    if "rot_err_deg" in out:
        print(f"vs ground truth: {out['rot_err_deg']:.3f} deg / {out['trans_err_cm']:.3f} cm")
    return out


if __name__ == "__main__":
    main()
