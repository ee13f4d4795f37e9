"""Port vs JAX: the robust pose stages of the checkpoint-free pipeline —
RANSAC (pool, winner, verified branches), IRLS Kabsch, ICP in every mode,
spectral matching and FGR — on the same inputs, with JAX's own Gumbel
noise handed to the port's triplet draw.

Tolerances: poses within 1e-5 (‖ΔR‖_F/√2, max|Δt|; fp32 sums in other
orders); inlier masks and vote counts equal; continuous weights within
1e-5, except ICP's within 1e-3: its robust weight exp(−(r/s)²) divides by
a MAD scale s of ~1 mm, so a 1e-6 difference in the pose moves it by up to
~5e-4 (measured).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu.data.synthetic import random_rotation
from se3_equi_graph_registration_tpu.ops import fgr as jfgr
from se3_equi_graph_registration_tpu.ops import icp as jicp
from se3_equi_graph_registration_tpu.ops import kabsch as jkabsch
from se3_equi_graph_registration_tpu.ops import ransac as jransac
from se3_equi_graph_registration_tpu.ops import spectral as jspectral
from se3_equi_graph_registration_tpu_torch.ops import fgr as tfgr
from se3_equi_graph_registration_tpu_torch.ops import icp as ticp
from se3_equi_graph_registration_tpu_torch.ops import kabsch as tkabsch
from se3_equi_graph_registration_tpu_torch.ops import numerics as tnum
from se3_equi_graph_registration_tpu_torch.ops import ransac as transac
from se3_equi_graph_registration_tpu_torch.ops import spectral as tspectral

N, M, K = 512, 256, 128


def T(a):
    return torch.from_numpy(np.array(a))


def _pose_close(got, ref, tol=1e-5):
    (Rg, tg), (Rr, tr) = got, ref
    assert np.linalg.norm(np.asarray(Rr) - Rg.numpy(), axis=(-2, -1)).max() / np.sqrt(2) <= tol
    assert np.abs(np.asarray(tr) - tg.numpy()).max() <= tol


@pytest.fixture(scope="module")
def matches():
    """N putative pairs, 40% true under a random pose (2 mm noise), the rest
    random; scores in (0, 1] on mutual rows, exactly 0 on the others (ties,
    as mutual matching gives)."""
    rng = np.random.default_rng(4)
    src = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    R = random_rotation(rng).astype(np.float32)
    t = (rng.standard_normal(3) * 0.3).astype(np.float32)
    tgt = src @ R.T + t + rng.standard_normal((N, 3)).astype(np.float32) * 0.002
    out = rng.random(N) > 0.4
    tgt[out] = rng.uniform(-1.5, 1.5, (out.sum(), 3))
    scores = np.where(rng.random(N) < 0.6, rng.uniform(0.2, 1.0, N), 0.0).astype(np.float32)
    return src, tgt, scores, R, t


def _noise(seed, m=M, k=K):
    return jax.random.PRNGKey(seed), T(jax.random.gumbel(jax.random.PRNGKey(seed), (k, 3, m)))


def test_gumbel_max_draw_is_jax_categorical():
    """The port's triplet draw, argmax(noise + logits), with JAX's noise is
    `jax.random.categorical(key, logits[None], shape=(K, 3))`."""
    logits = jnp.log(jnp.asarray(np.random.default_rng(0).uniform(1e-3, 1, M), jnp.float32))
    key, noise = _noise(3)
    ref = np.asarray(jax.random.categorical(key, logits[None, :], shape=(K, 3)))
    got = torch.argmax(noise + T(logits), dim=-1).numpy()
    np.testing.assert_array_equal(got, ref)
    g = transac.gumbel_noise(0, (4, 3, 5), batch=2)
    assert g.shape == (2, 4, 3, 5) and torch.equal(g, transac.gumbel_noise(0, (4, 3, 5), 2))


def test_top_m_breaks_ties_like_lax_top_k(matches):
    _, _, scores, _, _ = matches
    _, ref = jax.lax.top_k(jnp.asarray(scores), M)
    np.testing.assert_array_equal(transac.top_m(T(scores), M).numpy(), np.asarray(ref))


@pytest.mark.parametrize("vote", ["count", "msac"])
def test_ransac_pose_matches_jax(matches, vote):
    src, tgt, scores, R, t = matches
    key, noise = _noise(1)
    ref = jax.jit(lambda a, b, s, k: jransac.ransac_pose(
        a, b, s, k, hypotheses=K, top_m=M, solver="quaternion", vote=vote))(src, tgt, scores, key)
    Rg, tg, wg = transac.ransac_pose(T(src), T(tgt), T(scores), noise, top_m=M,
                                     solver="quaternion", vote=vote)
    _pose_close((Rg, tg), ref[:2])
    np.testing.assert_array_equal(wg.numpy(), np.asarray(ref[2]))
    assert np.linalg.norm(Rg.numpy() - R) < 0.05


def test_hypothesis_pool_and_branches_match_jax(matches):
    src, tgt, scores, _, _ = matches
    key, noise = _noise(2)
    pool = jransac._hypothesis_pool(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(scores),
                                    key, K, M, 0.09, "quaternion", "count")
    got = transac._hypothesis_pool(T(src), T(tgt), T(scores), noise, M, 0.09, "quaternion",
                                   "count")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(pool[2]))      # candidates
    _pose_close((got[3], got[4]), (pool[3], pool[4]))                       # hypotheses
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(pool[5]))      # inlier masks
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(pool[6]))      # votes
    ref = jax.jit(lambda a, b, s, k: jransac.ransac_pose_branches(
        a, b, s, k, branches=4, hypotheses=K, top_m=M, solver="quaternion"))(
        src, tgt, scores, key)
    Rg, tg, wg = transac.ransac_pose_branches(T(src)[None], T(tgt)[None], T(scores)[None],
                                              noise[None], 4, top_m=M, solver="quaternion")
    _pose_close((Rg[0], tg[0]), ref[:2])
    np.testing.assert_array_equal(wg[0].numpy(), np.asarray(ref[2]))


def test_median_and_quantile_follow_jax():
    """jnp.median averages the two middle values at even n (torch.median
    takes the lower); jnp.quantile is linear."""
    x = np.random.default_rng(0).standard_normal((3, 2048)).astype(np.float32)
    np.testing.assert_array_equal(tnum.median(T(x)).numpy(),
                                  np.asarray(jnp.median(x, axis=-1, keepdims=True)))
    for q in (0.35, 0.4, 0.5):
        np.testing.assert_array_equal(tnum.quantile(T(x), q).numpy(),
                                      np.asarray(jnp.quantile(x, q, axis=-1, keepdims=True)))


@pytest.mark.parametrize("kernel", ["geman", "welsch", "huber", "cauchy"])
def test_kabsch_irls_matches_jax_at_even_n(matches, kernel):
    src, tgt, scores, _, _ = matches
    ref = jax.jit(lambda a, b, w: jkabsch.kabsch_irls(a, b, w, iters=5, kernel=kernel,
                                                      solver="quaternion"))(src, tgt, scores)
    got = tkabsch.kabsch_irls(T(src), T(tgt), T(scores), iters=5, kernel=kernel,
                              solver="quaternion")
    _pose_close(got[:2], ref[:2])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-5)


@pytest.fixture(scope="module")
def clouds():
    """A wavy surface sampled twice independently (N points each), the
    target under a known pose, and a start pose ~3 deg / 3 cm off."""
    rng = np.random.default_rng(6)

    def surf(n):
        xy = rng.uniform(-1, 1, (n, 2))
        z = 0.25 * np.sin(3 * xy[:, :1]) * np.cos(2 * xy[:, 1:])
        return np.concatenate([xy, z], -1).astype(np.float32)

    R = random_rotation(rng).astype(np.float32)
    t = (rng.standard_normal(3) * 0.3).astype(np.float32)
    src, tgt = surf(N), surf(N) @ R.T + t
    w = np.asarray([0.03, -0.04, 0.02])
    K_ = np.asarray([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    th = np.linalg.norm(w)
    dR = np.eye(3) + np.sin(th) / th * K_ + (1 - np.cos(th)) / th ** 2 * K_ @ K_
    return src, tgt, (dR @ R).astype(np.float32), (t + 0.03).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(mode="point"), dict(mode="plane"), dict(mode="symmetric"), dict(mode="gicp"),
    dict(mode="plane", trim=0.4), dict(mode="plane", trim="auto"), dict(mode="point", tau=0.05),
], ids=["point", "plane", "symmetric", "gicp", "plane-trim", "plane-auto", "point-tau"])
def test_icp_refine_matches_jax(clouds, kw):
    src, tgt, R0, t0 = clouds
    ref = jax.jit(lambda a, b, r, s: jicp.icp_refine(a, b, r, s, iters=10, solver="quaternion",
                                                     **kw))(src, tgt, R0, t0)
    got = ticp.icp_refine(T(src), T(tgt), T(R0), T(t0), iters=10, solver="quaternion", **kw)
    _pose_close(got[:2], ref[:2])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-3)


def test_icp_guard_keeps_the_pose_on_a_singular_system():
    """All points on one spot: the 6x6 system is singular; solve_ex gives
    non-finite values that the step guard zeroes, as in JAX."""
    src = np.zeros((64, 3), np.float32)
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    R, t, _ = ticp.icp_refine(T(src), T(src), T(R0), T(t0), iters=3, mode="plane",
                              tgt_normals=T(np.tile([0, 0, 1.0], (64, 1)).astype(np.float32)))
    assert np.all(np.isfinite(R.numpy())) and np.allclose(R.numpy(), R0, atol=1e-6)


def test_spectral_weights_match_jax(matches):
    src, tgt, scores, _, _ = matches
    ref = jspectral.spectral_match_weights(jnp.asarray(src), jnp.asarray(tgt),
                                           jnp.asarray(scores), top_m=M)
    got = tspectral.spectral_match_weights(T(src), T(tgt), T(scores), top_m=M)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_fgr_matches_jax(matches):
    src, tgt, scores, R, _ = matches
    key, noise = _noise(5)
    ref = jax.jit(lambda a, b, s, k: jfgr.fgr_pose(a, b, s, k, top_m=M, tuples=K,
                                                   solver="quaternion"))(src, tgt, scores, key)
    got = tfgr.fgr_pose(T(src), T(tgt), T(scores), noise, top_m=M, solver="quaternion")
    _pose_close(got[:2], ref[:2], tol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-4)
    mask = jfgr.tuple_test(jnp.asarray(src[:M]), jnp.asarray(tgt[:M]), key, tuples=K)
    np.testing.assert_array_equal(tfgr.tuple_test(T(src[:M]), T(tgt[:M]), noise).numpy(),
                                  np.asarray(mask))


@pytest.mark.parametrize("scale", [0.0, 1e-7, 1e-3, 1.0, 3.0], ids=["zero", "taylor", "small", "1rad", "3rad"])
def test_skew_and_matrix_exp_so3_match_jax(scale):
    from se3_equi_graph_registration_tpu.core import se3 as jse3
    from se3_equi_graph_registration_tpu_torch.core import se3 as tse3

    w = (np.random.default_rng(2).standard_normal((16, 3)) * scale).astype(np.float32)
    np.testing.assert_array_equal(tse3.skew(T(w)).numpy(), np.asarray(jse3.skew(jnp.asarray(w))))
    got = tse3.matrix_exp_so3(T(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jse3.matrix_exp_so3(jnp.asarray(w))), atol=1e-6)
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2), np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-5)
