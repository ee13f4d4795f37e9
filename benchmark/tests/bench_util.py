"""Small sizes for running the benchmark's cells on the CPU."""
from __future__ import annotations

import torch

CELLS = ("3dmatch-train-b64", "kitti-train-b64", "3dmatch-eval-b64", "kitti-eval-b64")


def shrink(cell: str, batch: int = 2):
    """An `edit` for `run.run`: training at N=256 (whole cloud), serving at
    N=512 from 600 correspondences (the window of 384 needs N ≥ 384), pools
    of 3, two calls checked, two traced."""
    n, points = (256, 256) if "train" in cell else (512, 600)

    def edit(c):
        c.config["num_nodes"] = n
        c.config["top_k"] = min(c.config["top_k"], n)
        if c.config["top_k"] > 128:          # the KITTI head takes every correspondence
            c.config["top_k"] = n
        c.mix.update(batch=batch, points=points, pool=3)
        if "check_calls" in c.cell:
            c.cell["check_calls"] = 2
        c.cell["trace_calls"] = 2
    return edit


def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    return prev
