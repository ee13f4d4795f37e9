"""A train step's optimizer on the host: its `train.optimizer` span (Adam,
the schedule, clearing the gradients), ms a step in the traced window."""
from benchmark.metrics._spans import span_ms


def read(r):
    return span_ms(r, "train.optimizer")
