"""3x3 SVD for the Kabsch solve (counterpart of `ops/svd3.py`), forward only.

The reference's damped custom VJP belongs to training and comes with the
training slice; the forward is a plain float32 `torch.linalg.svd`.
"""
from __future__ import annotations

import torch


def svd3(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U, S, Vh) of square matrices [..., 3, 3] in float32."""
    return torch.linalg.svd(H.to(torch.float32), full_matrices=False)
