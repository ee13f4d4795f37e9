"""The train step's share of the chip's peak: its model FLOP (the forward
and the backward over both clouds, no recomputation counted) over the
step's time on the host clock, untraced, times the path's peak."""
from benchmark.metrics._read import mfu_pct


def read(r):
    return mfu_pct(r, r.shapes.train_model_ops())
