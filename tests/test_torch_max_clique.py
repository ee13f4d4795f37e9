"""The port's max-clique module (native/max_clique.py) and the Registrar's
clique prefilter against the JAX package's, on the CPU.

Tolerances: the solver, `pmc`, the consistency graph, the heuristic and the
clique labels are integer or {0,1} results on the same numpy inputs, so they
are held equal. The prefilter's pose (accurate EngineConfig, fp32 on both
sides, only summation orders differ) is held at the accurate serving gate
of tests/test_torch_serving.py: R and t within 1e-4.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation
from torch_port_util import jax_model_params

from se3_equi_graph_registration_tpu import serving as jserving
from se3_equi_graph_registration_tpu.native import max_clique as jmc
from se3_equi_graph_registration_tpu.train import engine as jengine
from se3_equi_graph_registration_tpu_torch import serving as tserving
from se3_equi_graph_registration_tpu_torch.native import max_clique as tmc
from se3_equi_graph_registration_tpu_torch.train import engine as tengine
from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax


def _brute_force_size(adj: np.ndarray) -> int:
    n = len(adj)
    for r in range(n, 0, -1):
        for comb in itertools.combinations(range(n), r):
            if all(adj[a, b] for a, b in itertools.combinations(comb, 2)):
                return r
    return 0


@pytest.mark.parametrize("seed", range(4))
def test_max_clique_equals_jax_and_brute_force(seed):
    rng = np.random.default_rng(seed)
    n = 14
    adj = np.triu(rng.uniform(size=(n, n)) < 0.45, 1)
    ei, ej = (a.astype(np.int32) for a in np.nonzero(adj))
    got = tmc.max_clique(ei, ej, n)
    assert sorted(got) == sorted(jmc.max_clique(ei, ej, n))
    full = adj | adj.T
    assert len(got) == _brute_force_size(full)
    assert all(full[a, b] for a, b in itertools.combinations(got, 2))
    assert sorted(tmc.pmc(ei, ej, n, len(ei))) == sorted(jmc.pmc(ei, ej, n, len(ei)))


def test_library_builds_into_the_ignored_build_directory():
    path = tmc.build_library()
    assert path.startswith(tmc.BUILD_DIR) and path.endswith(".so")
    assert tmc.max_clique(np.zeros(0, np.int32), np.zeros(0, np.int32), 3).size == 0


def _outlier_pair(rng, n=256, frac=0.4):
    """The JAX prefilter test's request (tests/test_serving.py:114): a rigid
    copy with the first 40% of targets replaced by gross outliers."""
    src = rng.standard_normal((n, 3)).astype(np.float32)
    R = Rotation.from_euler("xyz", [0.4, 0.1, -0.3]).as_matrix().astype(np.float32)
    tgt = src @ R.T + np.asarray([0.2, -0.1, 0.3], np.float32)
    n_bad = int(frac * n)
    tgt[:n_bad] = rng.standard_normal((n_bad, 3)).astype(np.float32) * 2.0
    return src, tgt, n_bad


def test_consistency_graph_and_heuristic_equal_jax():
    src, tgt, _ = _outlier_pair(np.random.default_rng(1), n=96)
    ei, ej = tmc.consistency_graph(src, tgt, tau=0.05)
    jei, jej = jmc.consistency_graph(src, tgt, tau=0.05)
    assert np.array_equal(ei, jei) and np.array_equal(ej, jej)
    adj = np.zeros((len(src), len(src)), np.float32)
    adj[ei, ej] = adj[ej, ei] = 1.0
    want = np.asarray(jmc.max_clique_heuristic_jax(jnp.asarray(adj), iters=len(src)))
    got = tmc.max_clique_heuristic(torch.from_numpy(adj), iters=len(src)).numpy()
    np.testing.assert_array_equal(got, want)
    chosen = np.flatnonzero(got)
    assert len(chosen) >= 3 and np.all(adj[np.ix_(chosen, chosen)] + np.eye(len(chosen)) == 1)


N, C = 256, 16


@pytest.fixture(scope="module")
def registrars():
    kw = dict(num_nodes=N, k=8, in_node_nf=C, hidden_nf=32, top_k=64)
    _, params = jax_model_params(jengine.EngineConfig(**kw), "train")
    ref = jserving.Registrar(params, jengine.EngineConfig(**kw), head_mode="train")
    got = tserving.Registrar(params_from_jax(params), tengine.EngineConfig(**kw),
                             head_mode="train", device="cpu")
    return ref, got


def test_clique_prefilter_matches_jax(registrars):
    ref, got = registrars
    rng = np.random.default_rng(0)
    src, tgt, n_bad = _outlier_pair(rng)
    feat = rng.standard_normal((N, C)).astype(np.float32)
    lbl = got._clique_labels(src, tgt, tau=0.05)
    np.testing.assert_array_equal(lbl, ref._clique_labels(src, tgt, tau=0.05))
    assert lbl[n_bad:].sum() >= 0.8 * (N - n_bad) and lbl[:n_bad].sum() <= 0.1 * n_bad
    Rr, tr, ir = ref.register(src, feat, tgt, feat, clique_prefilter=True, clique_tau=0.05)
    Rg, tg, ig = got.register(src, feat, tgt, feat, clique_prefilter=True, clique_tau=0.05)
    assert ig["clique_inliers"] == ir["clique_inliers"] == [int(lbl.sum())]
    assert all(type(v) is int for v in ig["clique_inliers"])
    assert np.linalg.norm(Rg - np.asarray(Rr)) / np.sqrt(2) < 1e-4
    np.testing.assert_allclose(tg, np.asarray(tr), atol=1e-4)
    assert ig["pose_covariance"].shape == (6, 6)


def test_degenerate_clique_labels_every_correspondence(registrars):
    _, got = registrars
    pts = np.zeros((N, 3), np.float32)
    pts[:, 0] = np.arange(N) * 10.0          # no pair length-consistent with a far target
    np.testing.assert_array_equal(got._clique_labels(pts, -3.0 * pts, 0.05), np.ones(N))


def test_batching_server_gives_each_future_its_clique_inliers(registrars):
    _, got = registrars
    rng = np.random.default_rng(2)
    reqs = []
    for frac in (0.4, 0.2):
        src, tgt, _ = _outlier_pair(rng, frac=frac)
        reqs.append((src, rng.standard_normal((N, C)).astype(np.float32), tgt))
    server = tserving.BatchingServer(got, max_batch=4, max_wait_ms=50)
    try:
        futs = [server.submit(s, f, t, f, clique_prefilter=True, clique_tau=0.05)
                for s, f, t in reqs]
        futs.append(server.submit(*reqs[0][:3], reqs[0][1]))
        results = [f.result(timeout=120) for f in futs]
    finally:
        server.close()
    assert not server._thread.is_alive()
    for (s, f, t), (R, _, info) in zip(reqs, results):
        Rs, _, alone = got.register(s, f, t, f, clique_prefilter=True, clique_tau=0.05)
        assert info["clique_inliers"] == alone["clique_inliers"][0]
        np.testing.assert_allclose(R, Rs, atol=1e-6)
    assert results[0][2]["clique_inliers"] != results[1][2]["clique_inliers"]
    assert "clique_inliers" not in results[2][2]

