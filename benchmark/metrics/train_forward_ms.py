"""A train step's forward on the host: its `train.forward` span (the loss
with every launch of the forward), ms a step in the traced window."""
from benchmark.metrics._spans import span_ms


def read(r):
    return span_ms(r, "train.forward")
