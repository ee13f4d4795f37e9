"""What the program-span readers share: a named host stage's time a call or
step, and the serving front's byte counter, from a `trace.Reading`."""
from __future__ import annotations


def span_ms(r, name: str) -> float | None:
    """Milliseconds of the program's spans named `name` in the traced window
    (the host events the reading keeps, the benchmark's own left out), over
    its calls; None where the program records no such span."""
    hits = [b - a for a, b, n, bench in r._spans if n == name and not bench]
    return sum(hits) * 1e-3 / r.calls if hits else None


def copy_in_mb() -> float | None:
    """Megabytes a `register()` call copied host to device, from the serving
    module's counters over the whole run (every call of a cell has one
    size); None where the program keeps no such counter or made no call."""
    try:
        from se3_equi_graph_registration_tpu_torch import serving
    except ImportError:
        return None
    counters = getattr(serving, "counters", None)
    if not isinstance(counters, dict) or not counters.get("calls"):
        return None
    return counters["bytes_in"] / counters["calls"] / 1e6
