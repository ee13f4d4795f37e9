"""Plots of registrations, correspondences and descriptors (counterpart of
`tools/viz.py`), with matplotlib, imported only when a plot is drawn: it is
an optional extra, and the card machine does not have it. Host plotting of
numpy arrays; nothing here runs on a device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _require_matplotlib():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_registration(src_pts: np.ndarray, tgt_pts: np.ndarray,
                      pred_pose: Optional[np.ndarray] = None,
                      gt_pose: Optional[np.ndarray] = None,
                      path: str = "registration.png",
                      max_points: int = 2000) -> str:
    """Before/after registration scatter (two 3D panels); with both poses
    the second panel's title gives the RRE and RTE."""
    plt = _require_matplotlib()
    from ..core import se3_np

    idx = np.random.default_rng(0).choice(
        len(src_pts), min(max_points, len(src_pts)), replace=False)
    s, t = src_pts[idx], tgt_pts[idx]

    fig = plt.figure(figsize=(12, 5))
    ax1 = fig.add_subplot(121, projection="3d")
    ax1.scatter(*s.T, s=1, c="tab:blue", label="source")
    ax1.scatter(*t.T, s=1, c="tab:orange", label="target")
    ax1.set_title("input")
    ax1.legend()

    ax2 = fig.add_subplot(122, projection="3d")
    if pred_pose is not None:
        s2 = se3_np.transform(s, pred_pose)
        ax2.scatter(*s2.T, s=1, c="tab:blue", label="source @ pred")
    ax2.scatter(*t.T, s=1, c="tab:orange", label="target")
    if gt_pose is not None and pred_pose is not None:
        import torch

        from ..train.metrics import calculate_pose_error
        re, te = calculate_pose_error(torch.as_tensor(np.asarray(gt_pose)),
                                      torch.as_tensor(np.asarray(pred_pose)))
        ax2.set_title(f"registered (RRE {float(re):.2f}°, RTE {float(te):.1f} cm)")
    else:
        ax2.set_title("registered")
    ax2.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_correspondences(src_pts: np.ndarray, tgt_pts: np.ndarray,
                         labels: np.ndarray, path: str = "correspondences.png",
                         max_lines: int = 200) -> str:
    """Inlier (green) and outlier (red) correspondence lines."""
    plt = _require_matplotlib()
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(*src_pts.T, s=1, c="tab:blue")
    ax.scatter(*tgt_pts.T, s=1, c="tab:orange")
    rng = np.random.default_rng(0)
    idx = rng.choice(len(src_pts), min(max_lines, len(src_pts)), replace=False)
    for i in idx:
        color = "g" if labels[i] > 0 else "r"
        ax.plot(*np.stack([src_pts[i], tgt_pts[i]]).T, c=color, lw=0.3, alpha=0.5)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_feature_tsne(features: np.ndarray, labels: Optional[np.ndarray] = None,
                      path: str = "features_tsne.png") -> str:
    """A 2-D t-SNE of per-point descriptors; without scikit-learn, their
    first two principal components."""
    plt = _require_matplotlib()
    try:
        from sklearn.manifold import TSNE
        emb = TSNE(n_components=2, init="pca",
                   perplexity=min(30, len(features) - 1)).fit_transform(features)
    except ImportError:   # host plotting without scikit-learn: PCA
        mu = features.mean(0)
        _, _, vt = np.linalg.svd(features - mu, full_matrices=False)
        emb = (features - mu) @ vt[:2].T
    fig, ax = plt.subplots(figsize=(6, 6))
    c = labels if labels is not None else "tab:blue"
    sc = ax.scatter(emb[:, 0], emb[:, 1], s=3, c=c, cmap="coolwarm")
    if labels is not None:
        fig.colorbar(sc)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
