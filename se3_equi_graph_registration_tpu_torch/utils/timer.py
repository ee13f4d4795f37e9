"""Timing / averaging utilities (counterpart of `utils/timer.py`; capability
parity with the reference's utils/timer.py:28-55 `Timer` / `AverageMeter`)
plus a `device_timer` that waits for the card: PyTorch returns from a CUDA
call before the device finishes, so the clock stops only after the work
queued on the current stream has run."""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Optional

import torch


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.avg = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.avg = self.total_time / self.calls
        return self.avg if average else self.diff


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.sq_sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.sq_sum += val ** 2 * n
        self.var = self.sq_sum / self.count - self.avg ** 2


@contextmanager
def device_timer(label: str, device: Optional[torch.device] = None,
                 sink: Callable[[str], None] = print):
    """Time the block on the host clock and report `label: <ms> ms` to
    `sink`. On a CUDA `device` the block's work is bracketed by two CUDA
    events and the device time between them is reported beside the wall
    time (both after a synchronize); on the CPU (or `device=None`) only the
    wall time, since CPU ops finish before they return."""
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record(torch.cuda.current_stream(device))
    t0 = time.perf_counter()
    yield
    if cuda:
        e1.record(torch.cuda.current_stream(device))
        torch.cuda.synchronize(device)
    wall = (time.perf_counter() - t0) * 1e3
    sink(f"{label}: {wall:.2f} ms" + (f" (device {e0.elapsed_time(e1):.2f} ms)" if cuda else ""))
