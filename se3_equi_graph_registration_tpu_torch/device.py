"""Device selection shared by the port's entry points.

The port runs on the CUDA card unless the caller asks for the CPU. There is
no silent fallback: without a card, an entry point given no device raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` → the current CUDA device, or RuntimeError when there is none;
    anything else → `torch.device(device)` (a CUDA device that does not
    exist raises too)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
