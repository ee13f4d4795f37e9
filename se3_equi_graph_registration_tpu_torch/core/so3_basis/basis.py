"""Equivariant kernel basis: the Q_J change of basis and the SH-based kernels
(counterpart of `core/so3_basis/basis.py`).

Q_J is the intertwiner of the defining identity

    kron(D_a(g), D_b(g)) @ Q_J = Q_J @ D_J(g)     for all g ∈ SO(3),

computed on the host as the common nullspace of that constraint for two
generic rotations (a float64 SVD, cached), the same construction as the JAX
package's; up to the choice of column basis these are the real
Clebsch-Gordan coefficients. `get_basis` evaluates the kernels
K_J = Y_J · Q_Jᵀ with the port's spherical harmonics, in float64 on the
device of its input.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .spherical_harmonics import spherical_harmonics_xyz
from .wigner import irr_repr


@functools.lru_cache(maxsize=None)
def basis_transformation_Q_J(J: int, d_in: int, d_out: int) -> np.ndarray:
    """Q_J [(2d_in+1)(2d_out+1), 2J+1] with kron(D_in, D_out) Q = Q D_J."""
    assert abs(d_in - d_out) <= J <= d_in + d_out, (J, d_in, d_out)
    n_in, n_out, n_j = 2 * d_in + 1, 2 * d_out + 1, 2 * J + 1
    dim = n_in * n_out

    rng = np.random.default_rng(12345)
    blocks = []
    for _ in range(2):
        a, b, c = rng.uniform(-np.pi, np.pi, 3)
        K = np.kron(irr_repr(d_in, a, b, c), irr_repr(d_out, a, b, c))
        DJ = irr_repr(J, a, b, c)
        # constraint on vec(Q): (K ⊗ I − I ⊗ DJᵀ) vec(Q) = 0
        blocks.append(np.kron(K, np.eye(n_j)) - np.kron(np.eye(dim), DJ.T))
    A = np.concatenate(blocks, axis=0)
    _, s, vt = np.linalg.svd(A)
    tol = max(1e-8 * s[0], 1e-10)   # absolute floor: (0,0,0) has an all-zero A
    null_dim = int(np.sum(s < tol))
    assert null_dim == 1, f"expected 1-dim intertwiner space, got {null_dim}"
    Q = vt[-1].reshape(dim, n_j)
    # normalize so QᵀQ = I (columns orthonormal up to a common scale)
    return Q / np.sqrt(np.trace(Q.T @ Q) / n_j)


def get_basis(rel_pos, max_degree: int) -> dict[str, torch.Tensor]:
    """Equivariant kernel basis for every (d_in, d_out) degree pair.

    rel_pos: [..., 3] relative positions (a tensor, or numpy for the CPU).
    Returns {'<d_in>,<d_out>': [..., 2d_out+1, 2d_in+1, n_freq]} in float64
    on rel_pos's device, n_freq = 2·min(d_in, d_out) + 1 frequencies
    J = |d_in − d_out| .. d_in + d_out, K_J = reshape(Y_J(r̂) @ Q_Jᵀ) — the
    reference's get_basis contract and key naming."""
    rel = torch.as_tensor(rel_pos).to(torch.float64)
    basis: dict[str, torch.Tensor] = {}
    for d_in in range(max_degree + 1):
        for d_out in range(max_degree + 1):
            freqs = []
            for J in range(abs(d_in - d_out), d_in + d_out + 1):
                Y = spherical_harmonics_xyz(J, rel)                     # [..., 2J+1]
                Q = torch.from_numpy(basis_transformation_Q_J(J, d_in, d_out)).to(rel.device)
                K = (Y @ Q.T).reshape(rel.shape[:-1] + (2 * d_in + 1, 2 * d_out + 1))
                freqs.append(K.transpose(-1, -2))                       # [..., no, ni]
            basis[f"{d_in},{d_out}"] = torch.stack(freqs, dim=-1)
    return basis


def num_basis_entries(max_degree: int) -> int:
    """(max_degree+1)² degree pairs — the reference test_basis count oracle."""
    return (max_degree + 1) ** 2
