"""The slice as a whole: the port's Registrar against the JAX Registrar on
the same numpy requests and weights, at a small fast_tpu_config (N=512,
k=16, C=16, 2 layers, 2 heads, top_k=32, tile 128, window 384).

Premise made explicit: on the CPU the JAX engine builds the EXACT window
graph while the port's plain path builds the PACKED one; the first test
asserts the two graphs agree on these inputs up to packed-key near-ties
(d² within 2⁻¹² relative of the k-th), of which it allows 1 row in 1024.

Tolerances:
- both sides accurate (egnn_accurate=True): fp32 everywhere; R within
  1e-4 (‖ΔR‖_F/√2), t within 1e-4, covariance 1e-3 relative, similarity
  mean 1e-4 relative — summation orders differ, nothing else.
- fast vs fast: the JAX CPU run computes fast mode in fp32 (interpret mode
  skips the bf16 cast and CPU DEFAULT precision is fp32) while the port
  rounds MLP operands to bf16, so this is a bf16 budget: R within 2e-2,
  t within 2e-2, similarity mean 2e-2 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import jax_model_params, neighbor_set_mismatches

from se3_equi_graph_registration_tpu import serving as jserving
from se3_equi_graph_registration_tpu.data.synthetic import make_pair_batch
from se3_equi_graph_registration_tpu.ops import morton as jm
from se3_equi_graph_registration_tpu.train import engine as jengine
from se3_equi_graph_registration_tpu_torch import serving as tserving
from se3_equi_graph_registration_tpu_torch.ops import morton as tm
from se3_equi_graph_registration_tpu_torch.ops.kernels.knn import knn_window
from se3_equi_graph_registration_tpu_torch.train import engine as tengine
from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

N, C = 512, 16
SMALL = dict(num_nodes=N, k=16, in_node_nf=C, hidden_nf=C, n_layers=2,
             num_heads=2, top_k=32)


def _registrars(accurate: bool):
    kw = dict(SMALL, egnn_accurate=accurate)
    _, params = jax_model_params(jengine.fast_tpu_config(**kw), "eval_fusion")
    ref = jserving.Registrar(params, jengine.fast_tpu_config(**kw))
    got = tserving.Registrar(params_from_jax(params), tengine.fast_tpu_config(**kw),
                             device="cpu")
    return ref, got


def _requests():
    rng = np.random.default_rng(11)
    pb = make_pair_batch(rng, batch=2, n=N, feat_dim=C)
    short = make_pair_batch(rng, batch=1, n=N - 100, feat_dim=C)   # needs padding
    return pb, short


def _compare(ref, got, tol_r, tol_t, tol_cov, tol_sim):
    Rr, tr, ir = ref
    Rg, tg, ig = got
    d = np.linalg.norm(np.asarray(Rr) - Rg, axis=(-2, -1)) / np.sqrt(2)
    assert np.all(d < tol_r), d
    np.testing.assert_allclose(tg, np.asarray(tr), atol=tol_t)
    cr = np.asarray(ir["pose_covariance"])
    if tol_cov is not None:
        np.testing.assert_allclose(ig["pose_covariance"], cr, rtol=tol_cov,
                                   atol=tol_cov * np.abs(cr).max())
    assert abs(ig["similarity_mean"] - ir["similarity_mean"]) <= tol_sim * abs(ir["similarity_mean"])


def test_graph_premise_exact_and_packed_window_graphs_agree():
    pb, _ = _requests()
    for pts in (pb.src_pts, pb.tgt_pts):
        xs = tm.sort_by_curve(torch.zeros(2, N, 1), torch.from_numpy(pts))[1]
        exact = tm.knn_graph_window(xs, 16, 128, 384).numpy()
        packed = knn_window(xs.contiguous(), 16, tile=128, window=384, packed=True).numpy()
        jax_xs = np.asarray(jm.sort_by_curve(jnp.zeros((2, N, 1)), jnp.asarray(pts))[1])
        np.testing.assert_array_equal(xs.numpy(), jax_xs)
        assert neighbor_set_mismatches(xs.numpy(), exact, packed) <= 1


@pytest.fixture(scope="module")
def accurate_pair():
    return _registrars(accurate=True)


def test_register_accurate_matches_jax_b1_b2_and_padding(accurate_pair):
    ref, got = accurate_pair
    pb, short = _requests()
    args1 = (pb.src_pts[0], pb.src_feat[0], pb.tgt_pts[0], pb.tgt_feat[0])
    r1, g1 = ref.register(*args1), got.register(*args1)
    assert g1[0].shape == (3, 3) and g1[2]["pose_covariance"].shape == (6, 6)
    _compare(r1, g1, 1e-4, 1e-4, 1e-3, 1e-4)
    args2 = (pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat)
    _compare(ref.register(*args2), got.register(*args2), 1e-4, 1e-4, 1e-3, 1e-4)
    args3 = (short.src_pts[0], short.src_feat[0], short.tgt_pts[0], short.tgt_feat[0])
    r3, g3 = ref.register(*args3, seed=5), got.register(*args3, seed=5)
    _compare(r3, g3, 1e-4, 1e-4, 1e-3, 1e-4)
    assert abs(np.linalg.det(g3[0]) - 1.0) < 1e-4


def test_register_fast_matches_jax_within_bf16_budget():
    ref, got = _registrars(accurate=False)
    pb, _ = _requests()
    args = (pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat)
    _compare(ref.register(*args), got.register(*args), 2e-2, 2e-2, None, 2e-2)


def test_batching_server_answers_concurrent_submits(accurate_pair):
    _, got = accurate_pair
    pb, _ = _requests()
    server = tserving.BatchingServer(got, max_batch=4, max_wait_ms=50)
    try:
        futs = [server.submit(pb.src_pts[i % 2], pb.src_feat[i % 2],
                              pb.tgt_pts[i % 2], pb.tgt_feat[i % 2]) for i in range(3)]
        results = [f.result(timeout=120) for f in futs]
    finally:
        server.close()
    assert not server._thread.is_alive()
    for i, (R, t, info) in enumerate(results):
        Rs, ts, _ = got.register(pb.src_pts[i % 2], pb.src_feat[i % 2],
                                 pb.tgt_pts[i % 2], pb.tgt_feat[i % 2])
        np.testing.assert_allclose(R, Rs, atol=1e-5)
        np.testing.assert_allclose(t, ts, atol=1e-5)
        assert info["pose_covariance"].shape == (6, 6)


def test_batching_server_survives_a_base_exception_in_register():
    """A register() that raises SystemExit (not an Exception) resolves the
    batch's futures with it, and the server thread goes on serving."""
    class Stub:
        calls = 0

        def register(self, src_pts, src_feat, tgt_pts, tgt_feat):
            Stub.calls += 1
            if Stub.calls == 1:
                raise SystemExit(3)
            b = len(src_pts)
            return (np.tile(np.eye(3), (b, 1, 1)), np.zeros((b, 3)),
                    {"similarity_mean": 1.0, "pose_covariance": np.zeros((b, 6, 6))})

    server = tserving.BatchingServer(Stub(), max_batch=1, max_wait_ms=1)
    try:
        pts, feat = np.zeros((4, 3), np.float32), np.zeros((4, 2), np.float32)
        first = server.submit(pts, feat, pts, feat)
        with pytest.raises(SystemExit):
            first.result(timeout=30)
        assert server._thread.is_alive()
        R, t, info = server.submit(pts, feat, pts, feat).result(timeout=30)
        np.testing.assert_array_equal(R, np.eye(3))
        assert info["pose_covariance"].shape == (6, 6)
    finally:
        server.close()
    assert not server._thread.is_alive()
