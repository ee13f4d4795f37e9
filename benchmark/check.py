"""The comparisons that decide `correct`: each number the program's run
gives against the plain reference's, held to its limit in the cell's file
(`workloads/<cell>.json`, "limits")."""
from __future__ import annotations

import numpy as np
import torch


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _change_gaps(p_prog: dict, p_ref: dict, p0: dict, kept: list) -> dict:
    """Per leaf of `kept`: the gap of the norms of the change from `p0`,
    against the larger of the reference leaf's change and the median
    leaf's."""
    dr = _norms({k: p_ref[k] - p0[k] for k in kept})
    dp = _norms({k: p_prog[k] - p0[k] for k in kept})
    med = float(np.median(list(dr.values())))
    return {k: abs(dp[k] - dr[k]) / max(dr[k], med, 1e-30) for k in kept}


def train_numbers(program: dict, reference: dict, p0: dict, detail: bool = False) -> dict:
    """Training, over the first steps: `loss_gap`, the largest relative gap
    of a step's loss; `loss1_gap`, the first step's; `sim1_gap`, the first
    step's similarity-consistency term's (the post-EGNN similarity,
    standardized, against the input one: the EGNN's whole output, through
    no pose solve); `corr1_gap`, the first step's correspondence term's
    (BCE of the score MLP's logits over the top-k by that similarity: the
    head, through no pose solve); `grad_gap`, over the leaves, the largest
    gap between the norms of the first gradient (the program's as Adam
    took it), each against the larger of the reference leaf's norm and the
    median leaf's; `change1_gap` and `change_gap`, the same of the norms of
    the parameters' change by the first step (Adam's update of the first
    gradient) and over all the steps, over the leaves whose reference
    gradient is at least a thousandth of the median leaf's (below that Adam
    moves a leaf by rounding alone). A leaf the program leaves unmoved, or
    moves double, reads 1. A cell compares the numbers its file gives
    limits for."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
    lp, lr = program["losses"], reference["losses"]
    loss_gap = max(rel(p["total"], r["total"]) for p, r in zip(lp, lr))
    gr = _norms(reference["grad"])
    gp = _norms({k: program["grad"].get(k, torch.zeros_like(v))
                 for k, v in reference["grad"].items()})
    med = float(np.median(list(gr.values())))
    grad = {k: abs(gp[k] - gr[k]) / max(gr[k], med, 1e-30) for k in gr}
    kept = [k for k in gr if gr[k] >= 1e-3 * med]
    change1 = _change_gaps(program["params1"], reference["params1"], p0, kept)
    change = _change_gaps(program["params"], reference["params"], p0, kept)
    out = {"loss_gap": loss_gap, "loss1_gap": rel(lp[0]["total"], lr[0]["total"]),
           "sim1_gap": rel(lp[0]["sim"], lr[0]["sim"]),
           "corr1_gap": rel(lp[0]["corr"], lr[0]["corr"]), "grad_gap": max(grad.values()),
           "change1_gap": max(change1.values()), "change_gap": max(change.values())}
    if detail:          # the leaves that set the gaps, each step's loss gap, the median leaf's
        out["grad_leaf"] = max(grad, key=grad.get)
        out["change_leaf"] = max(change, key=change.get)
        out["left_out"] = sorted(set(gr) - set(kept))
        out["term_gaps"] = [{k: rel(p[k], r[k]) for k in r} for p, r in zip(lp, lr)]
        out["grad_median_gap"] = float(np.median(list(grad.values())))
        out["change1_median_gap"] = float(np.median(list(change1.values())))
        out["change_median_gap"] = float(np.median(list(change.values())))
    return out


def register_numbers(program: dict, reference: dict) -> dict:
    """Serving, over the sampled calls: `rot_gap`, the largest
    ‖R − R_ref‖_F/√2 of a pair; `trans_gap`, the largest |t − t_ref| (m);
    `cov_gap`, the largest gap of a covariance entry against the largest
    entry of the pair's reference covariance; `sim_gap`, the largest
    relative gap of a call's mean post-EGNN similarity. A missing call
    reads infinity."""
    out = {"rot_gap": 0.0, "trans_gap": 0.0, "cov_gap": 0.0, "sim_gap": 0.0}
    for i, (Rr, tr, cr, sr) in reference.items():
        if i not in program:
            return dict.fromkeys(out, float("inf"))
        Rp, tp, cp, sp = program[i]
        if Rp.shape != Rr.shape:
            return dict.fromkeys(out, float("inf"))
        rot = np.linalg.norm((Rp - Rr).reshape(len(Rr), 9), axis=1) / np.sqrt(2.0)
        cov = (np.abs(cp - cr).reshape(len(cr), 36).max(1)
               / np.maximum(np.abs(cr).reshape(len(cr), 36).max(1), 1e-30))
        vals = {"rot_gap": rot.max(), "trans_gap": np.abs(tp - tr).max(), "cov_gap": cov.max(),
                "sim_gap": abs(sp - sr) / max(abs(sr), 1e-30)}
        for k, v in vals.items():
            out[k] = max(out[k], float(v)) if np.isfinite(v) else float("inf")
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number finite and at most its limit, {name: {value, limit}})."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table
