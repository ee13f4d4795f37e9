"""Pairs trained a second: every pair of every step of the window over the
window's time, host clock, from a synchronize to a synchronize."""


def read(w):
    return w.pairs / w.seconds
