"""The device trace of a traced window: `torch.profiler` over the window's
calls (CPU and CUDA activities), exported as a Chrome trace under TMPDIR,
read back and removed. The reduction keeps the device operations (kernels,
copies, fills) inside the window's own span, their union, and the host
spans and operations, which label the device's idle gaps."""
from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict

WINDOW_SPAN = "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Reading:
    """What the per-layer readers read: the device operations of the
    traced window, its length, the calls it held and the cell's shapes."""

    def __init__(self, events: list, calls: int, shapes, host_call_s: float, spans: tuple):
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW_SPAN]
        if not win:
            raise RuntimeError("the trace holds no window span")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        self.device_ops = [(e["name"], max(float(e["ts"]), w0),
                            min(float(e["ts"]) + float(e.get("dur", 0.0)), w1), e["cat"])
                           for e in events if e.get("cat") in DEVICE_CATS
                           and w0 <= float(e["ts"]) < w1]
        self.kernels = [(n, a, b) for n, a, b, c in self.device_ops if c == "kernel"]
        self.launches = len(self.device_ops)
        self.calls = calls
        self.shapes = shapes
        self.host_call_s = host_call_s
        merged = _union([(a, b) for _, a, b, _ in self.device_ops])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        self._gaps = _gaps(merged, w0, w1)
        host = [e for e in events if e.get("cat") in ("user_annotation", "cpu_op")
                and e.get("name") != WINDOW_SPAN and w0 <= float(e["ts"]) < w1]
        self._spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
                        e["cat"] == "user_annotation" and e["name"] in spans) for e in host]

    def kernel_s(self, include: str, exclude: str | None = None) -> float | None:
        """Seconds of the kernels whose name matches `include` and not
        `exclude` (regular expressions); None when no kernel matches."""
        inc, exc = re.compile(include), re.compile(exclude) if exclude else None
        hits = [b - a for n, a, b in self.kernels
                if inc.search(n) and not (exc and exc.search(n))]
        return sum(hits) * 1e-6 if hits else None

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (seconds summed by
        name) and the idle gaps' seconds by what the host was doing: the
        benchmark's span and the innermost host operation at each gap's
        middle."""
        by_op = defaultdict(float)
        for n, a, b, _ in self.device_ops:
            by_op[n[:160]] += (b - a) * 1e-6
        by_gap = defaultdict(float)
        for label, seconds in self._labelled_gaps():
            by_gap[label] += seconds
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_gap)}

    def _labelled_gaps(self):
        """(label, seconds) of every idle gap, by one sweep over the host
        spans' ends and starts and the gaps' middles in time order."""
        points = [(a, 1, i) for i, (a, _, _, _) in enumerate(self._spans)]
        points += [(b, 0, i) for i, (_, b, _, _) in enumerate(self._spans)]
        points += [((a + b) / 2, 2, g) for g, (a, b) in enumerate(self._gaps)]
        active = {}
        for _, kind, i in sorted(points):
            if kind == 1:
                active[i] = self._spans[i]
            elif kind == 0:
                active.pop(i, None)
            else:
                span = next((s[2] for s in active.values() if s[3]), "outside")
                ops = [s for s in active.values() if not s[3]]
                inner = min(ops, key=lambda s: s[1] - s[0])[2] if ops else None
                a, b = self._gaps[i]
                yield (span if inner is None else f"{span}/{inner}"), (b - a) * 1e-6


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _gaps(merged: list, w0: float, w1: float) -> list:
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def capture(run_calls, sync) -> list:
    """Trace `run_calls()` inside the window span, synchronizing before the
    span closes; returns the trace's complete events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            run_calls()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return [e for e in events if e.get("ph") == "X"]

