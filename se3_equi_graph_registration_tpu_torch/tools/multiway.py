"""Multiway trajectory optimization over gt.log relative-pose files
(counterpart of the JAX package's `tools/multiway.py`).

The user-facing entry for `ops/pose_graph.py` in the reference's own file
format: 3DMatch / Redwood `.log` blocks (`<i> <j> <n>` + a 4×4 transform,
`utils/trajectory.py`). Edges are every `i_j` block across the input logs
(odometry + loop closures alike); absolute poses integrate the consecutive
chain, then the GNC-robust Gauss-Newton graph fuses everything and writes
absolute poses back as `0_k` blocks. The graph runs on the CUDA card unless
`--device cpu` is given.

  python -m se3_equi_graph_registration_tpu_torch.tools.multiway \\
      --log odometry.log --log closures.log --out optimized.log \\
      [--robust geman] [--iters 15] [--device cpu]

Relative transforms are read as T_ij = pose of fragment j in fragment i's
frame (inv(T_i) @ T_j — the convention the reference's evaluation uses).
"""
from __future__ import annotations

import argparse

import numpy as np


def optimize_logs(logs: list[dict[str, np.ndarray]], iters: int = 15,
                  robust: str | None = "geman", device=None) -> dict[str, np.ndarray]:
    """Fuse {'i_j': T_ij} measurement dicts into absolute poses {'0_k': T_k}
    (fragment 0 anchored at identity). Numpy in and out; the solve is
    ops/pose_graph's optimizer on `device` (the card unless device='cpu')."""
    from ..ops.pose_graph import optimize_trajectory

    edges, rels = [], []
    for log in logs:
        for key, T in log.items():
            i, j = (int(x) for x in key.split("_"))
            edges.append((i, j))
            rels.append(np.asarray(T, np.float32))
    if not edges:
        raise ValueError("no edges found in the input logs")
    V = max(max(i, j) for i, j in edges) + 1

    # integrate the consecutive chain for the initial trajectory; missing
    # chain links fall back to the previous pose (a closure must then place
    # the fragment)
    by_edge = {e: r for e, r in zip(edges, rels)}
    init = [np.eye(4, dtype=np.float32)]
    for k in range(1, V):
        step = by_edge.get((k - 1, k), np.eye(4, dtype=np.float32))
        init.append(init[-1] @ step)

    opt = optimize_trajectory(np.stack(init), np.asarray(edges, np.int32),
                              np.stack(rels), robust=robust, iters=iters,
                              device=device).cpu().numpy()
    return {f"0_{k}": opt[k] for k in range(V)}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--log", action="append", required=True,
                    help="gt.log-format relative-pose file (repeatable)")
    ap.add_argument("--out", required=True, help="output absolute-pose log")
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--robust", default="geman",
                    help="edge kernel: geman|huber|cauchy|welsch|none")
    ap.add_argument("--device", default=None,
                    help="where the graph is solved (default: the CUDA card; "
                         "'cpu' for the CPU)")
    args = ap.parse_args(argv)

    from ..utils.trajectory import read_trajectory_log, write_trajectory_log

    logs = [read_trajectory_log(p) for p in args.log]
    robust = None if args.robust.lower() == "none" else args.robust
    poses = optimize_logs(logs, iters=args.iters, robust=robust, device=args.device)
    write_trajectory_log(args.out, poses, num_fragments=len(poses))
    print(f"wrote {len(poses)} absolute poses to {args.out}")


if __name__ == "__main__":
    main()
