"""Correspondence sampling (a copy of the JAX package's `data/sampling.py`,
which cannot be imported without jax): the host-side shim onto fixed shapes.

Reference semantics (verified against the reference's datasets/ThreeDMatch.py
:296-369 and the reference's datasets/KITTI.py:499-535), with explicit
`np.random.Generator` state instead of the global numpy RNG.
"""
from __future__ import annotations

import numpy as np


def fit_to_count(arr: np.ndarray, n: int, rng: np.random.Generator
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Sample down (without replacement) or pad (repeat with replacement) the
    leading axis to exactly `n` rows; returns (fitted array, row indices).
    The shared host-side shim onto compiled fixed shapes — used by
    serving.Registrar and registration.register_fpfh."""
    cur = arr.shape[0]
    if cur == n:
        return arr, np.arange(n)
    if cur > n:
        idx = rng.choice(cur, n, replace=False)
    else:
        idx = np.concatenate([np.arange(cur),
                              rng.choice(cur, n - cur, replace=True)])
    return arr[idx], idx
