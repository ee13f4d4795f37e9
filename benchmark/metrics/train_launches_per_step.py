"""Device operations (kernels, copies, fills) a call in the traced window:
an exact count where the program's path does not depend on the data."""


def read(r):
    return r.launches / r.calls
