"""Port vs JAX: masked softmax, weighted Kabsch (both solvers), the pose
covariance, score fusion, and both heads of RegistrationModel on the same
embeddings and weights.

Tolerances: fp32 on both sides; 1e-5 on softmax weights, 1e-4 on poses and
covariances (3x3 solvers of different libraries), rotations compared by
‖Ra − Rb‖_F/√2 (arccos misreads near zero angle); top-k compared as sets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import jax_model_params

from se3_equi_graph_registration_tpu.data.synthetic import random_rotation
from se3_equi_graph_registration_tpu.models import pose_head as jhead
from se3_equi_graph_registration_tpu.ops import kabsch as jk
from se3_equi_graph_registration_tpu.train import engine as jengine
from se3_equi_graph_registration_tpu_torch.models import pose_head as thead
from se3_equi_graph_registration_tpu_torch.ops import kabsch as tkb
from se3_equi_graph_registration_tpu_torch.train import engine as tengine
from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

T = torch.from_numpy


def rot_delta(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b), axis=(-2, -1)) / np.sqrt(2)


def test_masked_softmax_including_empty_mask(rng):
    s = rng.standard_normal((3, 64)).astype(np.float32) * 4
    m = (rng.uniform(size=(3, 64)) < 0.5).astype(np.float32)
    m[2] = 0.0
    ref = np.asarray(jk.masked_softmax(jnp.asarray(s), jnp.asarray(m)))
    got = tkb.masked_softmax(T(s), T(m)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)
    assert np.all(got[2] == 0.0)


@pytest.mark.parametrize("solver", ["svd", "quaternion"])
def test_kabsch_weighted_and_covariance(rng, solver):
    b, n = 4, 200
    src = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    R = np.stack([random_rotation(rng) for _ in range(b)]).astype(np.float32)
    t = rng.standard_normal((b, 3)).astype(np.float32)
    tgt = (src @ R.transpose(0, 2, 1) + t[:, None]
           + 0.01 * rng.standard_normal((b, n, 3))).astype(np.float32)
    w = rng.uniform(size=(b, n)).astype(np.float32)
    w[3] = 0.0                                     # empty weights → (I, 0)
    Rj, tj = jk.kabsch_weighted(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w),
                                solver=solver)
    Rt, tt = tkb.kabsch_weighted(T(src), T(tgt), T(w), solver=solver)
    assert np.all(rot_delta(Rt.numpy(), Rj) < 1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_array_equal(Rt.numpy()[3], np.eye(3, dtype=np.float32))
    assert np.all(rot_delta(Rt.numpy()[:3], R[:3]) < 1e-2)
    cj = np.asarray(jk.pose_covariance(jnp.asarray(src), jnp.asarray(tgt), Rj, tj,
                                       jnp.asarray(w + 1e-3)))
    ct = tkb.pose_covariance(T(src), T(tgt), Rt, tt, T(w + 1e-3)).numpy()
    np.testing.assert_allclose(ct, cj, rtol=1e-3, atol=1e-4 * np.abs(cj).max())


def _covariance_fp64(src, tgt, R, t, w, eps=1e-9):
    """The covariance formula of `pose_covariance` in numpy float64."""
    w = w.astype(np.float64) / (w.astype(np.float64).sum() + 1e-12)
    n_eff = 1.0 / ((w * w).sum() + 1e-12)
    rs = src.astype(np.float64) @ R.astype(np.float64).T
    r = rs + t.astype(np.float64) - tgt
    sigma2 = (w * (r * r).sum(-1)).sum() / 3.0
    ax = np.zeros((len(rs), 3, 3))
    ax[:, 0, 1], ax[:, 0, 2], ax[:, 1, 2] = -rs[:, 2], rs[:, 1], -rs[:, 0]
    ax -= ax.transpose(0, 2, 1)
    J = np.concatenate([-ax, np.broadcast_to(np.eye(3), ax.shape)], -1)
    M = np.einsum("n,nij,nik->jk", w, J, J) + eps * np.eye(6)
    return sigma2 / n_eff * np.linalg.inv(M)


@pytest.mark.parametrize("points", [1, 2, 3, 200])
def test_pose_covariance_where_few_points_carry_weight(rng, points):
    """Weights on 1, 2, 3 and 200 of 200 points. With fewer than 3, M has
    rank < 6 and its 1e-9 ridge is below float32's resolution: the JAX
    reference's float32 inverse is NaN and inf at one point and arbitrary
    at two (it need not equal the formula at all). The port evaluates in
    float64, so it equals the float64 formula within 1e-6 relative there
    and is finite. From 3 non-collinear points on, M is well conditioned
    and the port equals JAX at the existing test's tolerance."""
    n = 200
    src = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    R = random_rotation(rng).astype(np.float32)
    t = rng.standard_normal(3).astype(np.float32)
    tgt = (src @ R.T + t + 0.01 * rng.standard_normal((n, 3))).astype(np.float32)
    w = np.zeros(n, np.float32)
    w[:points] = rng.uniform(0.5, 1.0, points)
    cj = np.asarray(jk.pose_covariance(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(R),
                                       jnp.asarray(t), jnp.asarray(w)))
    ct = tkb.pose_covariance(T(src), T(tgt), T(R), T(t), T(w)).numpy()
    c64 = _covariance_fp64(src, tgt, R, t, w)
    assert ct.dtype == np.float32 and np.all(np.isfinite(ct))
    np.testing.assert_allclose(ct, c64, rtol=1e-6, atol=1e-6 * np.abs(c64).max())
    if points == 1:
        assert np.isnan(cj).any() or np.isinf(cj).any()     # the reference's fault
    elif points == 2:
        assert np.abs(cj - c64).max() > 0.1 * np.abs(c64).max()
    else:
        np.testing.assert_allclose(ct, cj, rtol=1e-3, atol=1e-4 * np.abs(cj).max())
    # a pose-graph edge weight taken from it stays finite and positive
    assert np.isfinite(1.0 / np.trace(ct)) and np.trace(ct) > 0


@pytest.mark.parametrize("literal", [False, True])
def test_fuse_scores(rng, literal):
    p = rng.uniform(0, 2, (2, 32)).astype(np.float32)
    r = rng.uniform(0, 2, (2, 32)).astype(np.float32)
    ref = np.asarray(jhead.fuse_scores(jnp.asarray(p), jnp.asarray(r), literal=literal))
    np.testing.assert_array_equal(thead.fuse_scores(T(p), T(r), literal=literal).numpy(), ref)


@pytest.mark.parametrize("head_mode,over", [
    ("train", {}),
    ("eval_fusion", {}),
    ("eval_fusion", dict(fusion_weighting="sharp", kabsch_solver="quaternion")),
])
def test_heads_match_jax_on_same_embeddings(rng, head_mode, over):
    n, c = 256, 16
    kw = dict(num_nodes=n, k=8, in_node_nf=c, hidden_nf=c, n_layers=1,
              num_heads=2, top_k=32, **over)
    jmodel, params = jax_model_params(jengine.EngineConfig(**kw), head_mode)
    model = tengine.build_model(tengine.EngineConfig(**kw), head_mode, device="cpu")
    model.load_state_dict(params_from_jax(params))
    f = lambda *s: rng.standard_normal((2, n) + s).astype(np.float32)
    raw_hs, raw_ht, hs, ht = f(c), f(c), f(c), f(c)
    raw_xs, raw_xt, xs, xt = f(3), f(3), f(3), f(3)
    labels = (rng.uniform(size=(2, n)) < 0.7).astype(np.float32)
    args = (raw_hs, raw_ht, raw_xs, raw_xt, hs, xs, ht, xt, labels)
    ref = jmodel.apply(params, *args, method="head_from_embeddings")
    with torch.no_grad():
        got = model.head_from_embeddings(*(T(a) for a in args))
    for b in range(2):
        assert set(got.top_indices[b].tolist()) == set(np.asarray(ref.top_indices[b]).tolist())
    order = lambda o, b: np.argsort(np.asarray(o.top_indices[b]))
    for b in range(2):
        np.testing.assert_allclose(got.scores[b].numpy()[order(got, b)],
                                   np.asarray(ref.scores[b])[order(ref, b)],
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(ref.weights),
                               atol=1e-6, rtol=1e-5)
    assert np.all(rot_delta(got.R.numpy(), ref.R) < 1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)


def test_kabsch_from_features_matches_jax(rng):
    """Feature-softmax weights over the valid rows, then weighted Kabsch:
    R and t within the fp32 tolerances above; an all-invalid row gives the
    identity."""
    b, n, c = 3, 64, 8
    src = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    R = np.stack([random_rotation(rng) for _ in range(b)]).astype(np.float32)
    tgt = (np.einsum("bij,bnj->bni", R, src) + 0.3
           + rng.standard_normal((b, n, 3)) * 0.01).astype(np.float32)
    fs = rng.standard_normal((b, n, c)).astype(np.float32)
    ft = (fs + rng.standard_normal((b, n, c)) * 0.3).astype(np.float32)
    valid = (rng.uniform(size=(b, n)) < 0.6).astype(np.float32)
    valid[2] = 0.0
    Rr, tr = jk.kabsch_from_features(*(jnp.asarray(a) for a in (src, tgt, fs, ft, valid)))
    Rg, tg = tkb.kabsch_from_features(*(T(a) for a in (src, tgt, fs, ft, valid)))
    assert np.all(rot_delta(Rg, Rr) < 1e-4)
    np.testing.assert_allclose(tg.numpy(), np.asarray(tr), atol=1e-4)
    np.testing.assert_array_equal(Rg[2].numpy(), np.eye(3, dtype=np.float32))
    assert rot_delta(Rg[0], R[0]) < 5e-2
