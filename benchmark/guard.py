"""The check that a run loaded nothing of JAX: each module's top-level name
(the part before the first dot) compared whole, so the port, whose name
begins with the JAX package's, does not match it."""
from __future__ import annotations

import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "se3_equi_graph_registration_tpu"})


def jax_modules(modules=None) -> list:
    """The banned top-level names among `modules` (default: sys.modules)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & BANNED)
