"""Checkpoint-free global registration (counterpart of `registration.py`).

    R, t, info = register_fpfh(src_pts, tgt_pts, knn_method="fused",
                               knn_packed="chunked", window=768)

The classic pipeline with no learned model, batched over pairs:

    k-NN per cloud → normals → FPFH-33
      → mutual-nearest feature matching
      → coarse pose candidates: RANSAC (1 or more verified branches),
        spectral matching or FGR
      → IRLS-weighted Kabsch → point-to-plane (or other) ICP
      → the branch with the smallest trimmed NN residual; pose covariance.

knn_method='fused' (the fast mode) curve-sorts each cloud and runs the
descriptor stage through the hand-written kernels: the window k-NN (B1,
`knn_packed` False or True, or B4 for 'chunked') and the fused SPFH (B5);
'window' runs B1 with exact keys in the window and the gather FPFH;
'exact' and 'approx' run B1 over the whole cloud (the port has no
approximate k-selection; 'approx' selects the exact sets). Every later stage
is point-order invariant, so the pipeline runs in sorted order and only the
per-point weights are unsorted at the end.

`icp_voxels` runs ICP coarse to fine over a voxel pyramid
(`ops/icp.icp_refine_multiscale`); it must end at 0.0, the raw clouds, whose
final weights the covariance pairs with the raw source points. The
pipeline's matrix products run in full float32 whatever the caller set for
TF32 (`ops/numerics.fp32_matmuls`).

Entry points run on the card unless device='cpu'. `register_fpfh_batch`
sends its B pairs through each kernel as one launch per cloud side.
Not ported yet: the `mesh` of register_fpfh_batch (ROADMAP Queue A item 9),
export_compiled and load_exported (Queue A item 7).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .data.sampling import fit_to_count
from .device import resolve_device
from .ops import fpfh as fpfh_lib
from .ops import morton
from .ops.fgr import fgr_pose
from .ops.icp import (icp_refine, icp_refine_multiscale, nearest_neighbor,
                      point_covariances)
from .ops.kabsch import kabsch_irls, kabsch_weighted, pose_covariance
from .ops.kernels import knn as knn_kernels
from .ops.kernels import spfh as spfh_kernel
from .ops.knn import cross_dots, gather_rows, pairwise_sq_dists, sq_norms
from .ops.numerics import fp32_matmuls
from .ops.ransac import gumbel_noise, ransac_pose, ransac_pose_branches
from .ops.spectral import spectral_match_weights

__all__ = ["register_fpfh", "register_fpfh_batch", "match_features"]

_TILE = 128

DEFAULTS = dict(k_normals=30, k_fpfh=60, top_m=512, sigma=0.09, spectral_iters=12,
                refine_iters=5, icp_iters=10, icp_mode="plane", icp_tau=0.0,
                icp_trim=0.0, icp_voxels=(), coarse="ransac", hypotheses=512,
                knn_method="approx", solver="quaternion", window=768,
                knn_packed=False, ransac_vote="count", ransac_branches=4)


def match_features(src_feat: torch.Tensor, tgt_feat: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mutual-nearest matching of descriptors [..., N, C] and [..., M, C]:
    (j_of_i [..., N] — each source row's nearest target row, mutual
    [..., N] bool, dist [..., N] — its descriptor distance)."""
    d2 = pairwise_sq_dists(src_feat.float(), tgt_feat.float())     # [..., N, M]
    j_of_i = torch.argmin(d2, dim=-1)
    i_of_j = torch.argmin(d2, dim=-2)
    rows = torch.arange(d2.shape[-2], device=d2.device)
    mutual = torch.gather(i_of_j, -1, j_of_i) == rows
    dist = torch.sqrt(torch.gather(d2, -1, j_of_i[..., None])[..., 0])
    return j_of_i, mutual, dist


def _branch_verify_ms(R: torch.Tensor, t: torch.Tensor, src: torch.Tensor,
                      tgt: torch.Tensor, n_keep: int) -> torch.Tensor:
    """Trimmed NN mean-square per branch: R [..., Br, 3, 3], t [..., Br, 3],
    src [..., N, 3], tgt [..., M, 3] → [..., Br], the mean of the n_keep
    smallest squared NN distances of the posed source. The
    ‖p‖² − 2p·y + ‖y‖² cancellation leaves a ~1e-3 signal, so every product
    is written out in fp32 (no matmul that TF32 could round)."""
    s = src[..., None, :, None, :]                                   # [..., 1, N, 1, 3]
    Rr = R[..., :, None, :, :]                                       # [..., Br, 1, 3, 3]
    posed = ((Rr[..., 0] * s[..., 0] + Rr[..., 1] * s[..., 1]) + Rr[..., 2] * s[..., 2]
             + t[..., :, None, :])                                   # [..., Br, N, 3]
    tg = tgt[..., None, :, :]
    d2 = ((sq_norms(posed)[..., None] - 2.0 * cross_dots(posed, tg))
          + sq_norms(tg)[..., None, :])                              # [..., Br, N, M]
    dmin = torch.amin(d2, dim=-1)
    return torch.mean(torch.topk(dmin, n_keep, dim=-1, largest=False).values, dim=-1)


def _descriptors(x: torch.Tensor, kk: int, k_normals: int, k_fpfh: int, knn_method: str,
                 window: int, knn_packed) -> tuple[torch.Tensor, torch.Tensor]:
    """(normals, FPFH) of clouds x [B, N, 3] (curve-sorted for the window
    methods), through the k-NN and SPFH kernels."""
    if knn_method == "fused" and knn_packed == "chunked":
        nbr = knn_kernels.knn_chunked(x, kk, _TILE, window)
    elif knn_method in ("fused", "window"):
        nbr = knn_kernels.knn_window(x, kk, _TILE, window,
                                     packed=knn_method == "fused" and bool(knn_packed))
    else:   # whole cloud: the largest tile of at most 128 queries that divides N
        n = x.shape[-2]
        tile = max(d for d in range(1, _TILE + 1) if n % d == 0)
        nbr = knn_kernels.knn_window(x, kk, tile, None)
    if knn_method == "fused":
        normals = fpfh_lib.estimate_normals_window(x, nbr[..., :k_normals])
        nf = nbr[..., :k_fpfh].contiguous()
        spfh, dist = spfh_kernel.spfh(x, normals.contiguous(), nf, _TILE, window)
        return normals, fpfh_lib.fpfh_from_spfh(spfh, nf, dist)
    normals = fpfh_lib.estimate_normals(x, orient="local", nbr=nbr[..., :k_normals])
    return normals, fpfh_lib.fpfh(x, normals, nbr=nbr[..., :k_fpfh])


def _check_knobs(n: int, kw: dict) -> None:
    if kw["knn_method"] not in ("approx", "exact", "window", "fused"):
        raise ValueError(f"unknown knn_method {kw['knn_method']!r}")
    if kw["knn_packed"] not in (False, True, "chunked"):
        raise ValueError(f"knn_packed must be False, True or 'chunked', got {kw['knn_packed']!r}")
    if kw["coarse"] not in ("ransac", "spectral", "fgr"):
        raise ValueError(f"unknown coarse stage {kw['coarse']!r}; "
                         "expected 'spectral', 'ransac', or 'fgr'")
    if kw["icp_iters"] > 0 and kw["icp_voxels"] and kw["icp_voxels"][-1]:
        raise ValueError("icp_voxels must end at 0.0 (raw clouds): the final weights pair "
                         "with the raw source points for the covariance; got "
                         f"{kw['icp_voxels']}")
    win = min(kw["window"], n)
    if kw["knn_method"] in ("window", "fused") and (n % _TILE or win % _TILE):
        raise ValueError(f"knn_method={kw['knn_method']!r} needs n_points ({n}) and window "
                         f"({win}) to be multiples of {_TILE}; use knn_method='approx' for "
                         "odd sizes")


@torch.no_grad()
@fp32_matmuls()
def _register_core(src: torch.Tensor, tgt: torch.Tensor, noise: Optional[torch.Tensor],
                   k_normals: int, k_fpfh: int, top_m: int, sigma: float,
                   spectral_iters: int, refine_iters: int, icp_iters: int, icp_mode: str,
                   icp_tau: float, icp_trim, icp_voxels: tuple, coarse: str,
                   hypotheses: int, knn_method: str, solver: str, window: int, knn_packed,
                   ransac_vote: str, ransac_branches: int):
    """src/tgt [B, N, 3] on one device; noise [B, hypotheses, 3, M] for
    'ransac' and 'fgr'. Returns (R [B, 3, 3], t [B, 3], w [B, N], cov [B, 6, 6])."""
    b, n, _ = src.shape
    kk = min(max(k_normals, k_fpfh), n)
    win = min(window, n)
    perm_src = None
    if knn_method in ("window", "fused"):
        _, src, perm_src = morton.sort_by_curve(src[..., :0], src)
        _, tgt, _ = morton.sort_by_curve(tgt[..., :0], tgt)
        src, tgt = src.contiguous(), tgt.contiguous()
    n_src, f_src = _descriptors(src, kk, k_normals, k_fpfh, knn_method, win, knn_packed)
    n_tgt, f_tgt = _descriptors(tgt, kk, k_normals, k_fpfh, knn_method, win, knn_packed)

    j_of_i, mutual, dist = match_features(f_src, f_tgt)
    tgt_corr = gather_rows(tgt, j_of_i)
    scores = mutual.float() / (1.0 + dist)

    # the coarse stage gives a branch stack [B, Br, ...]; IRLS and ICP
    # refine every branch, and for Br > 1 the trimmed NN residual picks one
    if coarse == "ransac" and ransac_branches > 1:
        R, t, w = ransac_pose_branches(src, tgt_corr, scores, noise, ransac_branches,
                                       top_m=top_m, inlier_tau=sigma, solver=solver,
                                       vote=ransac_vote)
    else:
        if coarse == "ransac":
            R, t, w = ransac_pose(src, tgt_corr, scores, noise, top_m=top_m,
                                  inlier_tau=sigma, solver=solver, vote=ransac_vote)
        elif coarse == "fgr":
            R, t, w = fgr_pose(src, tgt_corr, scores, noise, top_m=top_m, delta=sigma,
                               solver=solver)
        else:
            w = spectral_match_weights(src, tgt_corr, scores, top_m=top_m, sigma=sigma,
                                       iters=spectral_iters)
            R, t = kabsch_weighted(src, tgt_corr, w, solver=solver)
        R, t, w = R[:, None], t[:, None], w[:, None]
    br = R.shape[1]

    def per_branch(a):
        return a[:, None].expand((b, br) + a.shape[1:])

    if refine_iters > 0:
        R, t, w = kabsch_irls(per_branch(src), per_branch(tgt_corr), w,
                              iters=refine_iters, solver=solver)
    if icp_iters > 0:
        icp_kw = dict(iters=icp_iters, mode=icp_mode, tau=icp_tau, trim=icp_trim,
                      normals_k=k_normals, solver=solver)
        if icp_mode in ("plane", "symmetric"):
            icp_kw["tgt_normals"] = per_branch(n_tgt)
        if icp_mode == "symmetric":
            icp_kw["src_normals"] = per_branch(n_src)
        if icp_mode == "gicp":
            icp_kw["src_cov"] = per_branch(point_covariances(src, normals=n_src))
            icp_kw["tgt_cov"] = per_branch(point_covariances(tgt, normals=n_tgt))
        if icp_voxels:
            R, t, w = icp_refine_multiscale(per_branch(src), per_branch(tgt), R, t,
                                            voxel_sizes=icp_voxels, **icp_kw)
        else:
            R, t, w = icp_refine(per_branch(src), per_branch(tgt), R, t, **icp_kw)
    if br > 1:
        vtrim = icp_trim if isinstance(icp_trim, float) and icp_trim > 0 else 0.35
        ms = _branch_verify_ms(R, t, src, tgt, max(int(vtrim * n), 1))      # [B, Br]
        # a branch whose refinement degenerated never wins
        ms = torch.where(torch.isfinite(ms), ms, torch.full_like(ms, torch.inf))
        ib = torch.argmin(ms, dim=-1)
        ar = torch.arange(b, device=src.device)
        R, t, w = R[ar, ib], t[ar, ib], w[ar, ib]
    else:
        R, t, w = R[:, 0], t[:, 0], w[:, 0]
    if icp_iters > 0:
        posed = torch.einsum("...ij,...nj->...ni", R, src) + t[..., None, :]
        nn, _ = nearest_neighbor(posed, tgt)
        cov = pose_covariance(src, gather_rows(tgt, nn), R, t, w)
    else:
        cov = pose_covariance(src, tgt_corr, R, t, w)
    if perm_src is not None:
        # only the per-point weights leave sorted order: w_orig[perm[r]] = w[r]
        w = torch.zeros_like(w).scatter(-1, perm_src, w)
    return R, t, w, cov


def _knobs(knobs: dict, who: str) -> dict:
    unknown = set(knobs) - set(DEFAULTS)
    if unknown:
        raise TypeError(f"unknown {who} knobs: {sorted(unknown)}")
    kw = dict(DEFAULTS, **knobs)
    kw["icp_voxels"] = tuple(kw["icp_voxels"])
    return kw


def _noise(kw: dict, m: int, seed: int, batch: Optional[int]) -> Optional[torch.Tensor]:
    if kw["coarse"] not in ("ransac", "fgr"):
        return None
    return gumbel_noise(seed, (kw["hypotheses"], 3, m), batch)


def register_fpfh(src_pts, tgt_pts, *, n_points: int = 2048, voxel: float = 0.0,
                  seed: int = 0, device: Union[str, torch.device, None] = None, **knobs):
    """Register two raw point clouds [N, 3] with no learned model.

    Host side: voxel downsample when `voxel > 0`, then sample or pad each
    cloud to `n_points` with a numpy generator seeded by
    `seed`; the RANSAC/FGR triplet draw is seeded by `seed` too. Knobs and
    defaults as the reference's (`DEFAULTS`). Returns (R [3, 3], t [3], info)
    with info 'weights' [n_points] over the sampled source rows,
    'pose_covariance' [6, 6] and 'indices' (the sampled source row ids).
    """
    kw = _knobs(knobs, "register_fpfh")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    src = np.asarray(src_pts, np.float32)
    tgt = np.asarray(tgt_pts, np.float32)
    if voxel > 0:
        src = fpfh_lib.voxel_downsample(src, voxel)
        tgt = fpfh_lib.voxel_downsample(tgt, voxel)
    src_f, src_idx = fit_to_count(src, n_points, rng)
    tgt_f, _ = fit_to_count(tgt, n_points, rng)
    kw["top_m"] = min(kw["top_m"], n_points)
    _check_knobs(n_points, kw)
    noise = _noise(kw, kw["top_m"], seed, None)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a))[None].to(dev)
    R, t, w, cov = _register_core(to(src_f), to(tgt_f), None if noise is None else to(noise),
                                  **kw)
    out = torch.cat([R.reshape(1, 9), t, cov.reshape(1, 36), w], dim=-1)[0].cpu().numpy()
    info = {"weights": out[48:], "pose_covariance": out[12:48].reshape(6, 6),
            "indices": src_idx}
    return out[:9].reshape(3, 3), out[9:12], info


def register_fpfh_batch(src_pts, tgt_pts, *, seed: int = 0, mesh=None,
                        device: Union[str, torch.device, None] = None, **knobs):
    """Batched register_fpfh: src/tgt [B, N, 3], already fixed-size. The B
    pairs run as one batch through every stage (one launch of each kernel
    per cloud side); the triplet noise of all pairs comes from one
    generator seeded by `seed`. Returns (R [B, 3, 3], t [B, 3], info with
    'weights' [B, N] and 'pose_covariance' [B, 6, 6])."""
    if mesh is not None:
        raise NotImplementedError("register_fpfh_batch(mesh=) (data-parallel pairs over "
                                  "several cards) is not ported yet (ROADMAP Queue A item 9)")
    kw = _knobs(knobs, "register_fpfh_batch")
    dev = resolve_device(device)
    src = torch.as_tensor(np.asarray(src_pts, np.float32)).to(dev)
    tgt = torch.as_tensor(np.asarray(tgt_pts, np.float32)).to(dev)
    b, n, _ = src.shape
    kw["top_m"] = min(kw["top_m"], n)
    _check_knobs(n, kw)
    noise = _noise(kw, kw["top_m"], seed, b)
    R, t, w, cov = _register_core(src.contiguous(), tgt.contiguous(),
                                  None if noise is None else noise.to(dev), **kw)
    out = torch.cat([R.reshape(b, 9), t, cov.reshape(b, 36), w], dim=-1).cpu().numpy()
    return (out[:, :9].reshape(b, 3, 3), out[:, 9:12],
            {"weights": out[:, 48:], "pose_covariance": out[:, 12:48].reshape(b, 6, 6)})
