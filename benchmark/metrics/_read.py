"""What the per-layer readers share: a kernel layer's roofline share and
the device's idle share, from a `trace.Reading`."""
from __future__ import annotations

from benchmark import work


def roofline_pct(r, include: str, exclude: str | None, work_of,
                 peak: float | None = None) -> float | None:
    """100 × the least time of the calls' work over the device time of the
    kernels that match: `work_of(shapes)` is (FLOP, bytes) of one call,
    against `peak` (the peak of the path's arithmetic when None). None where
    no kernel matches (the layer left the path)."""
    kernel_s = r.kernel_s(include, exclude)
    if kernel_s is None:
        return None
    ops, nbytes = work_of(r.shapes)
    least = work.least_s(nbytes, ops, peak or work.peak_ops(r.shapes.accurate))
    return 100.0 * r.calls * least / kernel_s


def idle_pct(r) -> float:
    """100 × (1 − a call's device time over its time on the host clock):
    the device time is the union of the device operations' intervals in
    the traced window over its calls, the host time the untraced window's
    over its calls, so the profiler's slowing of the host does not count
    as idle time."""
    return 100.0 * (1.0 - r.busy_s / r.calls / r.host_call_s)


def mfu_pct(r, model_ops: int) -> float:
    """100 × a call's model FLOP over its time on the host clock (untraced
    calls of the same run) times the path's peak."""
    return 100.0 * model_ops / (r.host_call_s * work.peak_ops(r.shapes.accurate))
