"""Fast Global Registration by graduated non-convexity (counterpart of
`ops/fgr.py`).

A tuple test over sampled triplets (length ratios within [scale, 1/scale])
gates the candidates; then mu anneals from the candidate cloud's squared
diameter to delta² while the Geman-McClure line process
l = (mu / (mu + r²))² and a weighted Kabsch solve alternate. The triplet
draw is Gumbel-max over `noise` [..., T, 3, M], as in ops/ransac.py.
"""
from __future__ import annotations

from typing import Optional

import torch

from .knn import gather_rows
from .kabsch import kabsch_weighted
from .ransac import scatter_rows, top_m as _top_m


def tuple_test(src: torch.Tensor, tgt: torch.Tensor, noise: torch.Tensor,
               scale: float = 0.95, logits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Float mask [..., M] of rows of src/tgt [..., M, 3] that appear in at
    least one triplet whose three length ratios d_src/d_tgt lie in
    (scale, 1/scale); all ones when no triplet passes."""
    m = src.shape[-2]
    if logits is None:
        logits = torch.zeros(src.shape[:-1], device=src.device)
    trip = torch.argmax(noise + logits[..., None, None, :], dim=-1)      # [..., T, 3]
    s = gather_rows(src.float(), trip)                                     # [..., T, 3, 3]
    t = gather_rows(tgt.float(), trip)
    ds = torch.linalg.vector_norm(s - torch.roll(s, -1, dims=-2), dim=-1)
    dt = torch.linalg.vector_norm(t - torch.roll(t, -1, dims=-2), dim=-1)
    nondegen = torch.all((ds > 1e-9) & (dt > 1e-9), dim=-1)
    ratio = ds / torch.clamp(dt, min=1e-9)
    ok = torch.all((ratio > scale) & (ratio < 1.0 / scale), dim=-1) & nondegen
    flat = trip.flatten(-2)
    mask = torch.zeros(src.shape[:-2] + (m,), device=src.device).scatter_reduce(
        -1, flat, ok.float().repeat_interleave(3, dim=-1), reduce="amax")
    return torch.where(torch.any(ok, dim=-1, keepdim=True), mask, torch.ones_like(mask))


def fgr_pose(src: torch.Tensor, tgt: torch.Tensor, scores: torch.Tensor,
             noise: torch.Tensor, top_m: int = 512, tuple_scale: float = 0.95,
             iters: int = 48, div_factor: Optional[float] = None,
             anneal_every: Optional[int] = None, delta: float = 0.09,
             solver: str = "svd") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Graduated-non-convexity pose from matched pairs src/tgt [..., N, 3];
    the top-M by `scores` and the tuple draw (noise [..., T, 3, M]) pick the
    candidates. div_factor=None anneals every step by the data-sized divisor
    (mu0/delta²)^(1/(0.75·iters)). Returns (R, t, weights [..., N])."""
    n = scores.shape[-1]
    m = min(int(top_m), n)
    sc = scores.float()
    cand = _top_m(sc, m)
    s = gather_rows(src.float(), cand)
    y = gather_rows(tgt.float(), cand)
    logits = torch.log(torch.clamp(torch.gather(sc, -1, cand), min=1e-30))
    mask = tuple_test(s, y, noise, scale=tuple_scale, logits=logits)

    span = torch.amax(s, dim=-2) - torch.amin(s, dim=-2)
    mu = torch.clamp(torch.sum(span * span, dim=-1), min=delta * delta)     # [...]
    if div_factor is None:
        if anneal_every is not None:
            raise ValueError(
                "anneal_every only applies to the classic fixed schedule: set "
                "div_factor explicitly alongside it (the default div_factor=None "
                "auto-sizes a per-step divisor)")
        steps = max(int(iters * 0.75), 1)
        step_div = (mu / (delta * delta)) ** (1.0 / steps)
        every = 1
    else:
        step_div = torch.full_like(mu, div_factor)
        every = 4 if anneal_every is None else anneal_every

    R = torch.eye(3, device=s.device).expand(s.shape[:-2] + (3, 3))
    t = torch.zeros(s.shape[:-2] + (3,), device=s.device)
    w = mask
    for i in range(iters):
        r2 = torch.sum((torch.einsum("...ij,...nj->...ni", R, s) + t[..., None, :] - y) ** 2,
                       dim=-1)
        w = mask * (mu[..., None] / (mu[..., None] + r2)) ** 2
        R, t = kabsch_weighted(s, y, w, solver=solver)
        if (i + 1) % every == 0:
            mu = torch.clamp(mu / step_div, min=delta * delta)
    return R, t, scatter_rows(w, cand, n)
