"""The serving call's share of the chip's peak: the forward's model FLOP
over both clouds over the call's time on the host clock, untraced, times
the path's peak."""
from benchmark.metrics._read import mfu_pct


def read(r):
    return mfu_pct(r, r.shapes.forward_model_ops())
