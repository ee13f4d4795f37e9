"""A train step's backward on the host: its `train.backward` span (the
wait while the autograd engine launches the backward), ms a step in the traced
window."""
from benchmark.metrics._spans import span_ms


def read(r):
    return span_ms(r, "train.backward")
