"""Megabytes a serving call copies host to device: the program's
`serving.counters` (bytes over calls)."""
from benchmark.metrics._spans import copy_in_mb


def read(r):
    return copy_in_mb()
