"""3x3 SVD with a degenerate-safe backward for the Kabsch pose solve
(counterpart of `ops/svd3.py`).

The standard SVD backward divides by σj² − σi²; when the cross-covariance H
degenerates (the correspondence weights collapse onto one point, H ≈ εI,
all singular values equal) that division is ±inf and one NaN poisons the
whole training step. `torch.linalg.svd`'s own backward has that trap. Here
the inverse is Tikhonov-damped: smooth everywhere, exact on well-separated
spectra (the damping is scale-aware and ~1e-12 relative).

The forward is a float32 `torch.linalg.svd`; only square [..., 3, 3] inputs
occur (the Kabsch H).
"""
from __future__ import annotations

import torch

_DAMP_REL = 1e-12


class _SVD3(torch.autograd.Function):

    @staticmethod
    def forward(ctx, H):
        U, S, Vh = torch.linalg.svd(H, full_matrices=False)
        ctx.save_for_backward(U, S, Vh)
        return U, S, Vh

    @staticmethod
    def backward(ctx, dU, dS, dVh):
        U, S, Vh = ctx.saved_tensors
        V, dV = Vh.mT, dVh.mT
        s2 = S * S
        smax = torch.clamp(torch.amax(S, dim=-1), min=1e-20)
        # F[i, j] = damped 1/(σj² − σi²): x / (x² + eps), eps ∝ σmax⁴, zero diagonal
        diff = s2[..., None, :] - s2[..., :, None]
        eps = _DAMP_REL * smax[..., None, None] ** 4 + 1e-30
        eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
        F = diff / (diff * diff + eps) * (1.0 - eye)
        UtdU = U.mT @ dU
        VtdV = V.mT @ dV
        inner = ((F * (UtdU - UtdU.mT)) * S[..., None, :]
                 + S[..., :, None] * (F * (VtdV - VtdV.mT))
                 + dS[..., :, None] * eye)
        return U @ inner @ Vh


def svd3(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U, S, Vh) of square matrices [..., 3, 3] in float32, with the damped
    backward."""
    return _SVD3.apply(H.to(torch.float32))
