"""Fixed-shape RANSAC pose hypotheses, batched (counterpart of `ops/ransac.py`).

All `hypotheses` minimal 3-point solves run as one batch, all
hypothesis × candidate residuals as one broadcast, and the vote's argmax
picks the winner. `ransac_pose_branches` returns the top vote winners that
are mutually distinct as poses (inlier-set overlap NMS), for verified
selection after refinement (registration.py).

Randomness: the reference draws the triplets with
`jax.random.categorical(key, logits, shape=(K, 3))`, which is Gumbel-max
over noise [K, 3, M]. Here the noise comes in as a tensor, drawn by
`gumbel_noise` from a seeded host generator, so the card and the CPU draw
the same triplets for one seed (and a test can pass JAX's own noise).

Tie order follows `lax.top_k` and `jnp.argmax`: the top-M candidates by a
stable descending sort (ties at the lowest index: every non-mutual match
scores exactly 0), and the first of equal votes.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kabsch import kabsch_weighted
from .knn import gather_rows


def gumbel_noise(seed: int, shape: tuple, batch: Optional[int] = None) -> torch.Tensor:
    """Standard Gumbel noise, float32 on the CPU: [*shape], or [batch, *shape]
    for `batch` pairs, from one generator seeded with `seed`."""
    g = torch.Generator().manual_seed(seed)
    full = tuple(shape) if batch is None else (batch,) + tuple(shape)
    u = torch.rand(full, generator=g, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def top_m(scores: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the m largest scores, ties at the lowest index."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :m]


def scatter_rows(values: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """zeros [..., n] with values [..., M] set at the distinct indices idx."""
    out = torch.zeros(values.shape[:-1] + (n,), dtype=values.dtype, device=values.device)
    return out.scatter(-1, idx, values)


def _hypothesis_pool(src, tgt, scores, noise, top, inlier_tau, solver, vote):
    """Candidate subset, minimal-sample solves and votes. noise [..., K, 3, M].
    Returns (s, y [..., M, 3], cand [..., M], R_h [..., K, 3, 3],
    t_h [..., K, 3], inl [..., K, M], gain [..., K])."""
    m = min(int(top), scores.shape[-1])
    if noise.shape[-1] != m or noise.shape[-2] != 3:
        raise ValueError(f"noise must be [..., K, 3, {m}], got {tuple(noise.shape)}")
    sc = scores.float()
    cand = top_m(sc, m)
    s = gather_rows(src.float(), cand)
    y = gather_rows(tgt.float(), cand)
    # score-proportional triplets; the 1e-30 floor keeps the logits finite
    logits = torch.log(torch.clamp(torch.gather(sc, -1, cand), min=1e-30))
    trip = torch.argmax(noise + logits[..., None, None, :], dim=-1)    # [..., K, 3]
    R_h, t_h = kabsch_weighted(gather_rows(s, trip), gather_rows(y, trip),
                               torch.ones(trip.shape, device=s.device), solver=solver)
    posed = torch.einsum("...kij,...mj->...kmi", R_h, s) + t_h[..., :, None, :]
    d2 = torch.sum((posed - y[..., None, :, :]) ** 2, dim=-1)         # [..., K, M]
    tau2 = inlier_tau * inlier_tau
    inl = d2 < tau2
    if vote == "count":
        gain = torch.sum(inl, dim=-1).float()
    elif vote == "msac":
        gain = torch.sum(torch.clamp(1.0 - d2 / tau2, min=0.0), dim=-1)
    else:
        raise ValueError(f"unknown vote {vote!r}; expected 'count' or 'msac'")
    return s, y, cand, R_h, t_h, inl, gain


def _refit(s, y, w, R_prev, t_prev, inlier_tau, solver):
    """Refit on an inlier set, then one re-inlier round against that pose;
    an empty set at either step keeps the previous pose."""
    def guarded(w, R0, t0):
        R2, t2 = kabsch_weighted(s, y, w, solver=solver)
        ok = torch.sum(w, dim=-1) > 0
        return (torch.where(ok[..., None, None], R2, R0), torch.where(ok[..., None], t2, t0))

    R, t = guarded(w, R_prev, t_prev)
    posed = torch.einsum("...ij,...nj->...ni", R, s) + t[..., None, :]
    w2 = (torch.sum((posed - y) ** 2, dim=-1) < inlier_tau * inlier_tau).float()
    R, t = guarded(w2, R, t)
    return R, t, w2


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a [..., K, *rest] at index i [...] along K."""
    idx = i.reshape(i.shape + (1,) * (a.dim() - i.dim()))
    idx = idx.expand(i.shape + (1,) + a.shape[i.dim() + 1:])
    return torch.gather(a, i.dim(), idx).squeeze(i.dim())


def ransac_pose(src: torch.Tensor, tgt: torch.Tensor, scores: torch.Tensor,
                noise: torch.Tensor, top_m: int = 256, inlier_tau: float = 0.09,
                solver: str = "svd", vote: str = "count"
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pose from matched pairs src/tgt [..., N, 3] by minimal-sample voting
    over the top-M by `scores` [..., N], K = noise.shape[-3] hypotheses;
    re-solved on the winner's inlier set. Returns (R, t, weights [..., N])."""
    n = scores.shape[-1]
    s, y, cand, R_h, t_h, inl, gain = _hypothesis_pool(
        src, tgt, scores, noise, top_m, inlier_tau, solver, vote)
    best = torch.argmax(gain, dim=-1)
    R, t, w_cand = _refit(s, y, _take(inl, best).float(), _take(R_h, best),
                          _take(t_h, best), inlier_tau, solver)
    return R, t, scatter_rows(w_cand, cand, n)


def ransac_pose_branches(src: torch.Tensor, tgt: torch.Tensor, scores: torch.Tensor,
                         noise: torch.Tensor, branches: int, top_m: int = 256,
                         inlier_tau: float = 0.09, solver: str = "svd",
                         vote: str = "count"
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The top-`branches` vote winners that are mutually distinct as poses:
    greedy NMS that suppresses every hypothesis whose inlier set overlaps a
    pick's refit inlier set by more than half. Returns (R [..., Br, 3, 3],
    t [..., Br, 3], w [..., Br, N]); with fewer distinct basins, later picks
    repeat index 0 of an all-suppressed vote."""
    n = scores.shape[-1]
    s, y, cand, R_h, t_h, inl, gain = _hypothesis_pool(
        src, tgt, scores, noise, top_m, inlier_tau, solver, vote)
    k = gain.shape[-1]
    inl_f = inl.float()
    counts = torch.clamp(torch.sum(inl_f, dim=-1), min=1.0)
    hyp = torch.arange(k, device=gain.device)
    Rs, ts, ws = [], [], []
    g = gain
    for _ in range(branches):
        bi = torch.argmax(g, dim=-1)
        R_b, t_b, w_b = _refit(s, y, _take(inl_f, bi), _take(R_h, bi), _take(t_h, bi),
                               inlier_tau, solver)
        Rs.append(R_b)
        ts.append(t_b)
        ws.append(scatter_rows(w_b, cand, n))
        overlap = torch.sum(inl_f * w_b[..., None, :], dim=-1) / counts
        same = (overlap > 0.5) | (hyp == bi[..., None])
        g = torch.where(same, torch.full_like(g, -torch.inf), g)
    return torch.stack(Rs, -3), torch.stack(ts, -2), torch.stack(ws, -2)
