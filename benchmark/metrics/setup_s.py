"""Set-up seconds, host clock: from the start of the process to the end of
the warm-up (imports, the kernels' build or load, weights, the pool of
requests, the first steps, the warm-up calls)."""


def read(w):
    return w.setup_s
