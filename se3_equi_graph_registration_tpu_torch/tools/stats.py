"""Dataset statistics (a copy of the JAX package's numpy-only
`tools/stats.py`, which cannot be imported without jax; capability parity
with the reference's dataloaders/stats.py inlier-ratio histograms and
dataloaders/process_3DMatch.py scene stats)."""
from __future__ import annotations

import json
from typing import Iterable

import numpy as np


def inlier_ratio_stats(dataset: Iterable, max_pairs: int | None = None) -> dict:
    """Inlier-ratio distribution over a pair dataset yielding the reference
    7-tuple (labels at index 1)."""
    ratios = []
    for i, sample in enumerate(dataset):
        labels = np.asarray(sample[1])
        ratios.append(float(labels.mean()))
        if max_pairs is not None and i + 1 >= max_pairs:
            break
    r = np.asarray(ratios)
    hist, edges = np.histogram(r, bins=10, range=(0.0, 1.0))
    return {
        "num_pairs": int(len(r)),
        "mean": float(r.mean()),
        "median": float(np.median(r)),
        "min": float(r.min()),
        "max": float(r.max()),
        "histogram": {f"{edges[i]:.1f}-{edges[i+1]:.1f}": int(hist[i])
                      for i in range(len(hist))},
    }


def print_stats(stats: dict) -> None:
    print(json.dumps(stats, indent=2))
