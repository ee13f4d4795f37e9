"""Wigner-D matrices in the real spherical-harmonic basis (a copy of the
JAX package's `core/so3_basis/wigner.py`, numpy only).

Capability parity with the reference's utils/irr_repr.py (irr_repr, z_rot_mat,
ZYZ `rot`, `compose`, x_to_alpha_beta) WITHOUT the reference's precomputed
`data/J_dense.npy` blob (stripped from the snapshot — SURVEY.md §7 'Wigner-D
data'): the matrices are generated from first principles via angular-momentum
generators —

  D^l(α, β, γ) = exp(−iα Jz) · exp(−iβ Jy) · exp(−iγ Jz)

with exp(−iβ Jy) from the eigendecomposition of the Hermitian Jy (no scipy),
then conjugated into the real-SH basis with the standard unitary U chosen to
match spherical_harmonics.py's convention. Precomputation runs in complex128
on host (numpy); the resulting real matrices are plain arrays usable on device.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _generators(l: int) -> tuple[np.ndarray, np.ndarray]:
    """(Jz, Jy) in the complex |l, m> basis, m = −l..l."""
    m = np.arange(-l, l + 1)
    jz = np.diag(m).astype(np.complex128)
    # ladder ops: J± |l,m> = sqrt(l(l+1) − m(m±1)) |l,m±1>
    jp = np.zeros((2 * l + 1, 2 * l + 1), np.complex128)
    for i, mm in enumerate(m[:-1]):
        jp[i + 1, i] = np.sqrt(l * (l + 1) - mm * (mm + 1))
    jm = jp.conj().T
    jy = (jp - jm) / (2j)
    return jz, jy


@functools.lru_cache(maxsize=None)
def _jy_eig(l: int):
    jz, jy = _generators(l)
    w, v = np.linalg.eigh(jy)
    return w, v


def wigner_d_complex(l: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Complex-basis D^l(α, β, γ) = e^{−iαJz} e^{−iβJy} e^{−iγJz}."""
    m = np.arange(-l, l + 1)
    w, v = _jy_eig(l)
    expbeta = (v * np.exp(-1j * beta * w)) @ v.conj().T
    ea = np.exp(-1j * alpha * m)
    eg = np.exp(-1j * gamma * m)
    return (ea[:, None] * expbeta) * eg[None, :]


@functools.lru_cache(maxsize=None)
def real_basis_transform(l: int) -> np.ndarray:
    """Unitary U with Y_real = U @ Y_complex, matching spherical_harmonics.py
    (real SH without Condon-Shortley in the Legendre recurrence).

    Complex SH here use the physics convention WITH Condon-Shortley:
    Y_l^m ∝ (−1)^m; our real SH omit it, so U carries the compensating phases:
      m > 0: Y_{l,m}  = ((−1)^m Y_l^m + Y_l^{−m}) / √2
      m = 0: Y_{l,0}  = Y_l^0
      m < 0: Y_{l,−m} = ((−1)^m Y_l^m − Y_l^{−m}) / (i√2)
    """
    n = 2 * l + 1
    U = np.zeros((n, n), np.complex128)
    for m in range(-l, l + 1):
        row = m + l
        if m == 0:
            U[row, l] = 1.0
        elif m > 0:
            U[row, l + m] = (-1.0) ** m / np.sqrt(2)
            U[row, l - m] = 1.0 / np.sqrt(2)
        else:
            am = -m
            U[row, l + am] = -((-1.0) ** am) / (1j * np.sqrt(2))
            U[row, l - am] = 1.0 / (1j * np.sqrt(2))
    return U


def irr_repr(l: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Real-basis irreducible representation D^l(α, β, γ) — the reference's
    `irr_repr` (utils/irr_repr.py:44) regenerated instead of loaded."""
    U = real_basis_transform(l)
    Dc = wigner_d_complex(l, alpha, beta, gamma)
    Dr = U @ Dc @ U.conj().T
    assert np.abs(Dr.imag).max() < 1e-10, "real-basis D must be real"
    return Dr.real


def rot_z(gamma: float) -> np.ndarray:
    c, s = np.cos(gamma), np.sin(gamma)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def rot_y(beta: float) -> np.ndarray:
    c, s = np.cos(beta), np.sin(beta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rot(alpha: float, beta: float, gamma: float) -> np.ndarray:
    """ZYZ rotation (reference utils/irr_repr.py `rot`)."""
    return rot_z(alpha) @ rot_y(beta) @ rot_z(gamma)


def compose(a1, b1, c1, a2, b2, c2) -> tuple[float, float, float]:
    """Compose two ZYZ angle triples (reference `compose`)."""
    return euler_angles(rot(a1, b1, c1) @ rot(a2, b2, c2))


def euler_angles(R: np.ndarray) -> tuple[float, float, float]:
    """ZYZ Euler angles of a rotation matrix (α, β, γ)."""
    beta = np.arccos(np.clip(R[2, 2], -1.0, 1.0))
    if abs(R[2, 2]) > 1 - 1e-12:  # gimbal: fold everything into alpha
        alpha = np.arctan2(R[1, 0], R[0, 0])
        if R[2, 2] < 0:
            alpha = -alpha
        gamma = 0.0
    else:
        alpha = np.arctan2(R[1, 2], R[0, 2])
        gamma = np.arctan2(R[2, 1], -R[2, 0])
    return float(alpha), float(beta), float(gamma)


def x_to_alpha_beta(x: np.ndarray) -> tuple[float, float]:
    """Direction vector → (α azimuth, β polar), reference convention
    (utils/irr_repr.py:82-95 / basis.py get_spherical_from_cartesian)."""
    x = np.asarray(x, np.float64)
    x = x / np.linalg.norm(x)
    beta = float(np.arccos(np.clip(x[2], -1.0, 1.0)))
    alpha = float(np.arctan2(x[1], x[0]))
    return alpha, beta


def wigner_d_from_matrix(l: int, R: np.ndarray) -> np.ndarray:
    """Real D^l for an arbitrary rotation matrix."""
    return irr_repr(l, *euler_angles(np.asarray(R, np.float64)))
