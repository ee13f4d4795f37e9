"""The benchmark's one traffic generator. A mix is a JSON file of
parameters beside this module (`<mix>.json`); this module turns a mix, a
descriptor width and a seed into a pool of distinct requests or batches.

Every pair is the Gaussian-bump height field of the repository's global
registration tests (30 bumps over [−1, 1]², a fixed scene) sampled at the
mix's `points`: the target is the source under a uniform random rotation
and a Gaussian translation, with `noise_m` of noise; a share of the
correspondences, drawn for each pair uniformly from `inlier_ratio`, are
inliers, the others point at an independent sample of the surface.
Descriptors are unit Gaussian vectors of the configuration's width, the
target's a noisy copy (`feature_noise`) for inliers and independent for
outliers. Labels mark the inliers and `gt_pose` is the pose.

Everything is drawn on the device from one `torch.Generator` seeded with
the run's seed, in a few calls a request: one seed, one pool.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
_BUMPS = 30


def load_mix(name: str) -> dict:
    """The parameters of the mix `name` (`traffic/<name>.json`)."""
    with open(os.path.join(HERE, f"{name}.json")) as f:
        return json.load(f)


def _surface(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scene's bumps (centers [30, 2], amplitudes, widths), fixed."""
    rng = np.random.default_rng(0)
    centers = rng.uniform(-1.6, 1.6, (_BUMPS, 2))
    amps = rng.uniform(-0.35, 0.35, _BUMPS)
    widths = rng.uniform(0.08, 0.3, _BUMPS)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return as_t(centers), as_t(amps), as_t(widths)


def _sample_surface(scene, shape: tuple, noise: float, gen: torch.Generator) -> torch.Tensor:
    """Points [*shape, 3] on the height field with `noise` of Gaussian noise."""
    centers, amps, widths = scene
    dev = centers.device
    xy = torch.rand(shape + (2,), generator=gen, device=dev) * 2.0 - 1.0
    d2 = torch.sum((xy[..., None, :] - centers) ** 2, dim=-1)           # [..., 30]
    z = torch.sum(amps * torch.exp(-d2 / widths), dim=-1)
    pts = torch.cat([xy, z[..., None]], dim=-1)
    return pts + torch.randn(pts.shape, generator=gen, device=dev) * noise


def _rotations(b: int, gen: torch.Generator, device) -> torch.Tensor:
    """b uniform random rotations [b, 3, 3] (normalized Gaussian quaternions)."""
    q = torch.randn((b, 4), generator=gen, device=device)
    w, x, y, z = (q / torch.linalg.norm(q, dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-6)


def make_request(mix: dict, feat_dim: int, gen: torch.Generator, scene) -> dict:
    """One request (serving) or batch (training) of `mix['batch']` pairs of
    `mix['points']` correspondences: float32 tensors on the generator's
    device, src_pts, tgt_pts [B, M, 3], src_feat, tgt_feat [B, M, C],
    labels [B, M], gt_pose [B, 4, 4]."""
    dev = scene[0].device
    b, m, noise = mix["batch"], mix["points"], mix["noise_m"]
    lo, hi = mix["inlier_ratio"]
    src = _sample_surface(scene, (b, m), noise, gen)
    other = _sample_surface(scene, (b, m), noise, gen)
    R = _rotations(b, gen, dev)
    t = torch.randn((b, 3), generator=gen, device=dev) * mix["translation_sigma_m"]
    ratio = lo + (hi - lo) * torch.rand((b, 1), generator=gen, device=dev)
    inl = torch.rand((b, m), generator=gen, device=dev) < ratio
    tgt = torch.where(inl[..., None], src, other) @ R.mT + t[:, None, :]
    tgt = tgt + torch.randn(tgt.shape, generator=gen, device=dev) * noise
    f = _unit(torch.randn((b, m, feat_dim), generator=gen, device=dev))
    noise_f = torch.randn((b, m, feat_dim), generator=gen, device=dev) * mix["feature_noise"]
    f_out = torch.randn((b, m, feat_dim), generator=gen, device=dev)
    ft = _unit(torch.where(inl[..., None], f + noise_f, f_out))
    pose = torch.eye(4, device=dev).repeat(b, 1, 1)
    pose[:, :3, :3], pose[:, :3, 3] = R, t
    return {"src_pts": src, "tgt_pts": tgt, "src_feat": f, "tgt_feat": ft,
            "labels": inl.to(torch.float32), "gt_pose": pose}


def make_pool(mix: dict, feat_dim: int, seed: int, device) -> list[dict]:
    """`mix['pool']` distinct requests drawn from `seed` on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    scene = _surface(device)
    return [make_request(mix, feat_dim, gen, scene) for _ in range(mix["pool"])]
