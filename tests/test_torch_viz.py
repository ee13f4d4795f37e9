"""Port vs JAX: `tools/viz`. Both packages draw the same plots from the same
numpy arrays: the files are byte for byte the same where the drawn data are
(matplotlib's Agg PNGs carry no time stamp), and the registration panel's
title (RRE, RTE through each package's `calculate_pose_error`) is the same
text. t-SNE's optimization (scikit-learn's) is not held: a stand-in records
the call; the PCA branch (no scikit-learn) is held."""
import sys

import numpy as np
import pytest

from se3_equi_graph_registration_tpu.tools import viz as jviz
from se3_equi_graph_registration_tpu_torch.tools import viz as tviz


@pytest.fixture(autouse=True)
def _matplotlib():
    pytest.importorskip("matplotlib")


@pytest.fixture
def scene(rng):
    src = rng.standard_normal((100, 3)).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, 0, 0]
    pred = pose.copy()
    c, s = np.cos(np.radians(2.0)), np.sin(np.radians(2.0))
    pred[:2, :2] = [[c, -s], [s, c]]                       # 2 degrees about z
    pred[:3, 3] = [0.12, 0.01, 0.0]
    labels = (rng.uniform(size=100) < 0.5).astype(np.float32)
    return src, src + pose[:3, 3], pose, pred, labels


def _titles(monkeypatch):
    from mpl_toolkits.mplot3d import Axes3D

    seen = []
    real = Axes3D.set_title

    def record(self, label, *a, **kw):
        seen.append(label)
        return real(self, label, *a, **kw)

    monkeypatch.setattr(Axes3D, "set_title", record)
    return seen


def test_plots_match_the_jax_packages(tmp_path, monkeypatch, scene):
    src, tgt, gt, pred, labels = scene
    titles = _titles(monkeypatch)
    for side, viz in (("jax", jviz), ("port", tviz)):
        viz.plot_registration(src, tgt, pred, gt, str(tmp_path / f"{side}_reg.png"))
        viz.plot_correspondences(src, tgt, labels, str(tmp_path / f"{side}_corr.png"))
    assert titles[:2] == titles[2:] and "RRE" in titles[1], titles
    for name in ("reg", "corr"):
        assert (tmp_path / f"port_{name}.png").read_bytes() == \
            (tmp_path / f"jax_{name}.png").read_bytes(), name


def test_feature_plot_calls_tsne_as_the_jax_package_does(tmp_path, monkeypatch, rng):
    """With scikit-learn: TSNE(n_components=2, init='pca', perplexity=
    min(30, n − 1)) on the descriptors (a recording stand-in here: the
    optimization itself is scikit-learn's), then the plot."""
    import types

    calls = []

    class TSNE:
        def __init__(self, **kw):
            calls.append(kw)

        def fit_transform(self, f):
            return np.asarray(f)[:, :2]

    monkeypatch.setitem(sys.modules, "sklearn.manifold", types.SimpleNamespace(TSNE=TSNE))
    feats = rng.standard_normal((20, 16))
    labels = (rng.uniform(size=20) < 0.5).astype(np.float32)
    a = jviz.plot_feature_tsne(feats, labels, str(tmp_path / "jax.png"))
    b = tviz.plot_feature_tsne(feats, labels, str(tmp_path / "port.png"))
    assert calls == [dict(n_components=2, init="pca", perplexity=19)] * 2
    assert open(a, "rb").read() == open(b, "rb").read()


def test_feature_plot_without_sklearn_is_the_jax_packages(tmp_path, monkeypatch, rng):
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)    # ImportError
    feats = rng.standard_normal((50, 16))
    labels = (rng.uniform(size=50) < 0.5).astype(np.float32)
    a = jviz.plot_feature_tsne(feats, labels, str(tmp_path / "jax.png"))
    b = tviz.plot_feature_tsne(feats, labels, str(tmp_path / "port.png"))
    assert open(a, "rb").read() == open(b, "rb").read()
