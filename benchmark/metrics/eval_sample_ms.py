"""A serving call's host sampling: its `register.sample` span (fitting each
pair to N correspondences, stacking the batch), ms a call in the traced window."""
from benchmark.metrics._spans import span_ms


def read(r):
    return span_ms(r, "register.sample")
