"""Numpy twins of core/se3.py for the host-side data pipeline (a copy of
the JAX package's `core/se3_np.py`, which cannot be imported without jax).

Dataset sampling and augmentation run on host CPU in the input pipeline
(numpy + np.random.Generator); the device path uses core/se3.py (torch). Both
implement the reference L0 semantics (the reference's datasets/ThreeDMatch.py:18-125).
"""
from __future__ import annotations

import numpy as np


def integrate_trans(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4, dtype=np.float64 if R.dtype == np.float64 else np.float32)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(t).reshape(3)
    return T


def decompose_trans(T: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return T[..., :3, :3], T[..., :3, 3]


def transform(pts: np.ndarray, T: np.ndarray) -> np.ndarray:
    R, t = decompose_trans(T)
    return pts @ R.T + t


def concatenate(T1: np.ndarray, T2: np.ndarray) -> np.ndarray:
    return T1 @ T2


def rotation_matrix(rng: np.random.Generator, num_axis: int,
                    augment_rotation: float) -> np.ndarray:
    """Random axis rotation(s), reference convention: three angles
    ~ U(0, 2π·augment_rotation), composed Rx @ Ry @ Rz
    (the reference's utils/SE3.py:17-30; one draw stream: angles then the
    axis choice for num_axis==1). Kept in float64 like the reference —
    callers cast at the serialization boundary."""
    if num_axis == 0:
        return np.eye(3)

    def _axis_rot(angle, axis):
        c, s = np.cos(angle), np.sin(angle)
        M = np.eye(3)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        M[i, i] = c
        M[j, j] = c
        M[i, j] = -s if axis != 1 else s
        M[j, i] = s if axis != 1 else -s
        return M

    # uniform(0, h, 3) and the reference's rand(3)*h are the same draw and
    # the same fp product — bit-replayable against a seeded legacy stream
    angles = rng.uniform(0, 2 * np.pi * augment_rotation, size=3)
    if num_axis == 1:
        a = int(rng.integers(0, 3))
        return _axis_rot(angles[a], a)
    if num_axis == 3:
        return (_axis_rot(angles[0], 0) @ _axis_rot(angles[1], 1)
                @ _axis_rot(angles[2], 2))
    raise ValueError(f"num_axis must be 0, 1 or 3, got {num_axis}")


def translation_matrix(rng: np.random.Generator,
                       augment_translation: float) -> np.ndarray:
    """~ U(0, augment_translation) per axis — the reference draws rand(3)*t
    (the reference's utils/SE3.py:32-41), NOT a gaussian."""
    return rng.random(3) * augment_translation


def random_pose(rng: np.random.Generator, num_axis: int = 3,
                augment_rotation: float = 1.0,
                augment_translation: float = 0.5) -> np.ndarray:
    return integrate_trans(rotation_matrix(rng, num_axis, augment_rotation),
                           translation_matrix(rng, augment_translation))
