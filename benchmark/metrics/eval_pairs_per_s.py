"""Pairs returned to the caller a second: every pair of every call that
returned over the window's time, host clock; a call that raises counts its
pairs as failed and none here."""


def read(w):
    return (w.pairs - w.failed) / w.seconds
