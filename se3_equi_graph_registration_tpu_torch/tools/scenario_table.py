"""The checkpoint-free pipeline's scenario table (counterpart of the JAX
package's `examples/scenario_table.py`).

Measures `registration.register_fpfh` accuracy per coarse stage ('ransac' |
'spectral' | 'fgr') on independently sampled bumpy height fields, the regime
with no exact point counterparts, at full, 60% and 40% overlap, over several
seeds a cell (the protocol of BASELINE.md's "Checkpoint-free global
registration" table).

    python -m se3_equi_graph_registration_tpu_torch.tools.scenario_table --seeds 20
    python -m se3_equi_graph_registration_tpu_torch.tools.scenario_table --coarse ransac \\
        --knn fused --packed chunked --window 768 --branches 4 --seeds 20
    python -m se3_equi_graph_registration_tpu_torch.tools.scenario_table --device cpu

Each cell prints min-max rotation error (deg, Frobenius small-angle metric)
and translation error (cm), and the success count at the 1 deg / 1.5 cm gate;
a cell of more than 8 seeds prints the worst success and the failing seeds
instead. The surfaces, poses and gate are the JAX script's, so its counts
read against BASELINE.md's. The triplet draws are the port's
(`ops/ransac.gumbel_noise`), not JAX's, so single seeds differ; cells of 20
seeds are what compare.
"""
from __future__ import annotations

import argparse

import numpy as np


def make_bumpy_surface(seed: int = 0):
    """Gaussian-bump height field: locally distinctive geometry (a periodic
    surface is self-similar, which makes partial-overlap matching ill-posed
    for any geometry-only method). The bump layout is fixed by `seed` (the
    layout is the surface, shared by every scenario); each call of the
    returned `surf(rng2, n, x0, x1)` samples n points with x in [x0, x1] from
    the caller's generator, with 2 mm noise."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1.6, 1.6, (30, 2))
    amps = rng.uniform(-0.35, 0.35, 30)
    widths = rng.uniform(0.08, 0.3, 30)

    def surf(rng2, n, x0, x1):
        xy = np.stack([rng2.uniform(x0, x1, n), rng2.uniform(-1, 1, n)], -1)
        z = np.zeros(n)
        for (cx, cy), a, w in zip(centers, amps, widths):
            z += a * np.exp(-((xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2) / w)
        pts = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
        return pts + rng2.standard_normal(pts.shape).astype(np.float32) * 0.002

    return surf


def rot_deg(Ra, Rb):
    d = np.linalg.norm(Ra - Rb) / np.sqrt(2.0)
    return np.degrees(2.0 * np.arcsin(np.clip(d / 2.0, 0.0, 1.0)))


# (label, target x-range, seeds, extra register_fpfh knobs). 40% overlap
# keeps the published protocol: top_m=256, overlap-fraction ICP trimming (a
# MAD scale is corrupted above 50% outliers), more ICP. Seed counts are the
# cells' defaults; --seeds overrides all (BASELINE.md's table uses 20).
SCENARIOS = [
    ("full overlap", (-1.0, 1.0), 3, {}),
    ("60% overlap", (-0.2, 1.8), 3, {}),
    ("40% + icp_trim=0.35", (0.2, 2.2), 5,
     dict(top_m=256, icp_trim=0.35, icp_iters=20)),
    ("40% + icp_trim='auto'", (0.2, 2.2), 3,
     dict(top_m=256, icp_trim="auto", icp_iters=20)),
]


def run_scenario(surf, coarse: str, x_range, seeds: int, knobs: dict,
                 extra: dict | None = None, device=None):
    """(rotation errors in deg, translation errors in cm, successes) over
    `seeds` pairs: seed s draws a 1024-point source, a random pose and a
    1024-point target over `x_range` from `np.random.default_rng(s)` and
    registers them with `register_fpfh(..., seed=s)` on `device` (the card
    unless told otherwise)."""
    from ..data.synthetic import random_rotation
    from ..registration import register_fpfh

    rot_errs, t_errs, ok = [], [], 0
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        src = surf(rng, 1024, -1.0, 1.0)
        R = random_rotation(rng).astype(np.float32)
        t = (rng.standard_normal(3) * 0.3).astype(np.float32)
        tgt = surf(rng, 1024, *x_range) @ R.T + t
        Rh, th, _ = register_fpfh(src, tgt, n_points=1024, coarse=coarse, seed=seed,
                                  device=device, **knobs, **(extra or {}))
        re, te = rot_deg(Rh, R), float(np.linalg.norm(th - t)) * 100.0
        rot_errs.append(re)
        t_errs.append(te)
        ok += (re < 1.0 and te < 1.5)
    return rot_errs, t_errs, ok


def cell_line(label: str, coarse: str, rot_errs, t_errs, ok: int) -> str:
    """One cell as the JAX script prints it."""
    seeds = len(rot_errs)
    worst_ok = max([r for r, t in zip(rot_errs, t_errs) if r < 1.0 and t < 1.5],
                   default=float("nan"))
    cells = " ".join(f"{r:6.2f}d/{t:5.2f}cm" for r, t in zip(rot_errs, t_errs))
    if seeds > 8:   # wide cells: summarize instead of spamming
        cells = f"worst-ok {worst_ok:.2f}d; fails " + " ".join(
            f"s{i}:{r:.0f}d" for i, (r, t) in enumerate(zip(rot_errs, t_errs))
            if not (r < 1.0 and t < 1.5))
    return f"{label:<24s} {coarse:<9s} {ok}/{seeds} ok   {cells}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coarse", nargs="+", default=["ransac", "spectral", "fgr"])
    ap.add_argument("--knn", default=None, choices=["exact", "approx", "window", "fused"],
                    help="override knn_method (default: register_fpfh's)")
    ap.add_argument("--solver", default=None, choices=["svd", "quaternion"],
                    help="override the Kabsch solver (default: register_fpfh's)")
    ap.add_argument("--seeds", type=int, default=None,
                    help="override every cell's seed count (BASELINE.md table protocol: 20)")
    ap.add_argument("--branches", type=int, default=None,
                    help="override ransac_branches (default: register_fpfh's)")
    ap.add_argument("--window", type=int, default=None,
                    help="override the Hilbert window size")
    ap.add_argument("--packed", nargs="?", const=True, default=False,
                    type=lambda v: v if v == "chunked" else bool(v),
                    help="packed k-NN extraction keys (knn fused only); pass 'chunked' "
                         "for two-level extraction")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card; raises when "
                         "there is none)")
    args = ap.parse_args(argv)

    surf = make_bumpy_surface()
    extra = {}
    if args.knn:
        extra["knn_method"] = args.knn
    if args.solver:
        extra["solver"] = args.solver
    if args.branches is not None:
        extra["ransac_branches"] = args.branches
    if args.window is not None:
        extra["window"] = args.window
    if args.packed:
        extra["knn_packed"] = args.packed
    for label, x_range, seeds, knobs in SCENARIOS:
        seeds = args.seeds or seeds
        for coarse in args.coarse:
            rot_errs, t_errs, ok = run_scenario(surf, coarse, x_range, seeds, knobs, extra,
                                                device=args.device)
            print(cell_line(label, coarse, rot_errs, t_errs, ok), flush=True)


if __name__ == "__main__":
    main()
