"""A serving call's forward on the host: its `register.forward` span (the
launch path of the curve sort, k-NN, EGNN, head, pose and covariance), ms a call
in the traced window."""
from benchmark.metrics._spans import span_ms


def read(r):
    return span_ms(r, "register.forward")
