"""3DMatch / Redwood `gt.log` trajectory I/O (a copy of the JAX package's
`utils/trajectory.py`, which cannot be imported without jax).

Capability parity with the reference's utils/trajectory.py and the
`__loadlog__` readers (datasets/ThreeDMatch.py:769-777,
dataloaders/Redwood.py:210-226): blocks of
  <id1> <id2> <num_fragments>
followed by four whitespace-separated rows of a 4x4 transform.
"""
from __future__ import annotations

import os
from typing import Mapping

import numpy as np


def read_trajectory_log(path: str) -> dict[str, np.ndarray]:
    """Parse a gt.log file → {'<id1>_<id2>': 4x4 ndarray}."""
    with open(path) as f:
        lines = f.readlines()
    result: dict[str, np.ndarray] = {}
    i = 0
    while i + 4 < len(lines) or (i < len(lines) and lines[i].strip()):
        header = lines[i].strip()
        if not header:
            i += 1
            continue
        ids = header.replace("\t", " ").split()
        trans = np.empty((4, 4))
        for r in range(4):
            trans[r] = np.fromstring(lines[i + 1 + r], dtype=float, sep=" \t")
        result[f"{int(ids[0])}_{int(ids[1])}"] = trans
        i += 5
    return result


def write_trajectory_log(path: str, trans: Mapping[str, np.ndarray],
                         num_fragments: int | None = None) -> None:
    """Inverse of read_trajectory_log (3DMatch evaluation format)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for key, T in trans.items():
            a, b = key.split("_")
            n = num_fragments if num_fragments is not None else int(b) + 1
            f.write(f"{a}\t{b}\t{n}\n")
            for row in np.asarray(T):
                f.write("\t".join(f"{v:.8f}" for v in row) + "\n")
