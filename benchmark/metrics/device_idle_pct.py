"""The device's idle share: 1 − a call's device time (the union of its
kernels', copies' and fills' intervals in the traced window) over a call's
time in the untraced window of the same run."""
from benchmark.metrics._read import idle_pct


def read(r):
    return idle_pct(r)
