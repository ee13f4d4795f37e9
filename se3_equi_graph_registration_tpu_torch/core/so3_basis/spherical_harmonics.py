"""Real (tesseral) spherical harmonics on tensors (counterpart of
`core/so3_basis/spherical_harmonics.py`), in the dtype and on the device of
the input; the identities of the basis need float64.

The associated Legendre values come from a recurrence unrolled per degree,
every step an elementwise tensor op.

Convention: orthonormal real SH WITHOUT the Condon-Shortley phase in the
Legendre recurrence (the (−1)^m is not applied), ordering m = −l..l:

  Y_{l,m}(θ, φ) = N_{l,|m|} P_l^{|m|}(cos θ) · {√2 sin|m|φ, 1, √2 cos mφ}
  N_{l,m} = sqrt((2l+1)/(4π) · (l−m)!/(l+m)!)

`wigner.py` builds its real-basis change to match exactly this convention
(Y(Rx) = D(R) Y(x)).
"""
from __future__ import annotations

import math

import torch


def _legendre_all(l_max: int, x: torch.Tensor) -> dict:
    """Associated Legendre P_l^m(x) (no Condon-Shortley) for all
    0 <= m <= l <= l_max, as {(l, m): tensor shaped like x}:
      P_m^m     = (2m-1)!! (1-x²)^{m/2}
      P_{m+1}^m = x (2m+1) P_m^m
      (l-m) P_l^m = x (2l-1) P_{l-1}^m − (l+m-1) P_{l-2}^m
    """
    out = {}
    somx2 = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))
    pmm = torch.ones_like(x)
    for m in range(l_max + 1):
        if m > 0:
            pmm = pmm * (2 * m - 1) * somx2
        out[(m, m)] = pmm
        if m < l_max:
            pmmp1 = x * (2 * m + 1) * pmm
            out[(m + 1, m)] = pmmp1
            p_prev, p_curr = pmm, pmmp1
            for l in range(m + 2, l_max + 1):
                p_next = (x * (2 * l - 1) * p_curr - (l + m - 1) * p_prev) / (l - m)
                out[(l, m)] = p_next
                p_prev, p_curr = p_curr, p_next
    return out


def _norm(l: int, m: int) -> float:
    return math.sqrt((2 * l + 1) / (4 * math.pi)
                     * math.factorial(l - m) / math.factorial(l + m))


def spherical_harmonics(l: int, theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Y_l(θ, φ) → [..., 2l+1], m ordered −l..l; θ the polar angle from +z
    (0..π), φ the azimuth (the reference's x_to_alpha_beta maps θ = beta,
    φ = alpha)."""
    P = _legendre_all(l, torch.cos(theta))
    cols = []
    for m in range(-l, l + 1):
        am = abs(m)
        base = _norm(l, am) * P[(l, am)]
        if m < 0:
            cols.append(math.sqrt(2.0) * base * torch.sin(am * phi))
        elif m == 0:
            cols.append(base)
        else:
            cols.append(math.sqrt(2.0) * base * torch.cos(m * phi))
    return torch.stack(cols, dim=-1)


def cartesian_to_angles(xyz: torch.Tensor, eps: float = 1e-12
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit-normalize and convert to (θ polar, φ azimuth)."""
    r = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    v = xyz / torch.clamp(r, min=eps)
    theta = torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))
    phi = torch.atan2(v[..., 1], v[..., 0])
    return theta, phi


def spherical_harmonics_xyz(l: int, xyz: torch.Tensor) -> torch.Tensor:
    """Y_l at cartesian directions [..., 3] → [..., 2l+1]."""
    theta, phi = cartesian_to_angles(xyz)
    return spherical_harmonics(l, theta, phi)


def all_spherical_harmonics(l_max: int, xyz: torch.Tensor) -> list[torch.Tensor]:
    """[Y_0, ..., Y_{l_max}] for cartesian input."""
    return [spherical_harmonics_xyz(l, xyz) for l in range(l_max + 1)]
