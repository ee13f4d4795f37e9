"""Port vs JAX: the voxel pyramid. `voxel_downsample` on JAX's own cases
(tests/test_voxel.py: the numpy oracle, the `num_out` spread, batching, the
int32-overflow and float32-fallback spreads) and on points placed exactly
on cell faces; `icp_refine_multiscale` (raw fields at the raw scale only);
`register_fpfh(icp_voxels=(v, 0.0))`.

Tolerances:
- voxel_downsample: `mask` and `count` equal; centroids within 1e-6 of
  JAX's (the sums run in another order: float32 rounding, measured 0) and
  1e-5 of the float64 oracle, as tests/test_voxel.py holds JAX;
- multiscale ICP on the easy problem and against the manual composition:
  R and t within 1e-5 (float32 sums in another order through 20 steps);
  on JAX's rippled basin case the end poses within 1e-4;
- register_fpfh at 60 ICP steps a scale: the tolerances of
  tests/test_torch_registration.py (‖ΔR‖_F/√2 and |Δt| ≤ 1e-4, 99% of the
  weights within 1e-3, covariance 1e-3 relative), with JAX's Gumbel noise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_registration import N_POINTS, WINDOW, _agree, _pair, bumpy, jax_noise  # noqa: F401

from se3_equi_graph_registration_tpu import registration as jreg
from se3_equi_graph_registration_tpu.data.synthetic import random_rotation
from se3_equi_graph_registration_tpu.ops import icp as jicp
from se3_equi_graph_registration_tpu.ops.voxel import voxel_downsample as jvoxel
from se3_equi_graph_registration_tpu_torch import registration as treg
from se3_equi_graph_registration_tpu_torch.ops import icp as ticp
from se3_equi_graph_registration_tpu_torch.ops.voxel import voxel_downsample as tvoxel


def _oracle(pts, v):
    cells = np.floor(pts / v).astype(np.int64)
    uniq, inv = np.unique(cells, axis=0, return_inverse=True)
    return np.stack([pts.astype(np.float64)[inv.ravel() == i].mean(0) for i in range(len(uniq))])


def _both(pts, v, num_out=None):
    ref = [np.asarray(a) for a in jvoxel(jnp.asarray(pts), v, num_out=num_out)]
    got = [a.numpy() for a in tvoxel(torch.from_numpy(pts), v, num_out=num_out)]
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)
    return got


def test_voxel_downsample_matches_oracle_and_jax(rng):
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    cent, mask, cnt = _both(pts, 0.25)
    oracle = _oracle(pts, 0.25)
    assert int(cnt) == len(oracle) and mask.sum() == cnt and mask[:cnt].all()
    np.testing.assert_allclose(cent[:cnt], oracle, atol=1e-5)
    pad = np.arange(300)[~mask]
    np.testing.assert_array_equal(cent[pad], cent[pad % cnt])


@pytest.mark.parametrize("voxel", [0.1, 0.23, 0.25, 0.3])
def test_voxel_cells_of_points_on_cell_faces_match_jax(voxel):
    """Coordinates k·voxel (rounded to float32) sit on a cell face, where
    p / voxel and p · (1/voxel) can floor to different cells: the port's
    cells, hence mask, count and centroids, equal JAX's."""
    rng = np.random.default_rng(int(voxel * 100))
    pts = rng.uniform(-1, 1, (2, 400, 3)).astype(np.float32)
    face = (rng.integers(-6, 7, pts.shape).astype(np.float32) * np.float32(voxel))
    pts = np.where(rng.uniform(size=pts.shape) < 0.6, face, pts).astype(np.float32)
    for num_out in (None, 64):
        _both(pts, voxel, num_out)


def test_voxel_downsample_num_out_spreads_as_jax(rng):
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    cent, mask, cnt = _both(pts, 0.1, num_out=64)
    assert cent.shape == (64, 3) and int(cnt) == 64 and mask.all()
    assert cent[:, 0].min() < -0.8 and cent[:, 0].max() > 0.8
    assert len(np.unique(np.round(cent, 5), axis=0)) == 64


def test_voxel_downsample_batched_and_validation(rng):
    pts = rng.uniform(-1, 1, (2, 3, 128, 3)).astype(np.float32)
    cent, mask, cnt = _both(pts, 0.5)
    assert cent.shape == (2, 3, 128, 3) and mask.shape == (2, 3, 128) and cnt.shape == (2, 3)
    for i in range(2):
        for j in range(3):
            assert int(cnt[i, j]) == len(_oracle(pts[i, j], 0.5))
    with pytest.raises(ValueError, match="scalar"):
        tvoxel(torch.from_numpy(pts), torch.ones(3))
    with pytest.raises(ValueError, match="num_out"):
        tvoxel(torch.from_numpy(pts), 0.5, num_out=0)


def _grid(nx, ny, nz):
    g = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"),
                 -1).reshape(-1, 3)
    return g, ((g + 0.5) * 0.1).astype(np.float32)


def test_voxel_spread_no_int32_overflow_as_jax():
    """One point a cell on a 50x50x48 grid (120000 cells) at num_out 30000:
    the exact spread ⌊j·v/num_out⌋, as the int64 oracle gives it."""
    g, pts = _grid(50, 50, 48)
    cent, mask, cnt = _both(pts, 0.1, num_out=30_000)
    assert int(cnt) == 30_000 and mask.all()
    order = np.lexsort((g[:, 2], g[:, 1], g[:, 0]))
    spread = (np.arange(30_000, dtype=np.int64) * len(g)) // 30_000
    np.testing.assert_allclose(cent, pts[order][spread], atol=1e-5)


def test_voxel_spread_float32_fallback_as_jax():
    """Above num_out 46340 the spread is JAX's float32 one (monotone, in
    range, not all distinct): the port takes the same rows."""
    g, pts = _grid(48, 48, 56)
    cent, mask, cnt = _both(pts, 0.1, num_out=50_000)
    assert int(cnt) == 50_000 and mask.all()
    order = np.lexsort((g[:, 2], g[:, 1], g[:, 0]))
    approx = np.floor(np.arange(50_000, dtype=np.float32)
                      * (np.float32(len(g)) / 50_000)).astype(np.int64)
    np.testing.assert_allclose(cent, pts[order][np.clip(approx, 0, len(g) - 1)], atol=1e-5)


def _surface(rng, n, f=6.0):
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    z = 0.3 * np.sin(f * xy[:, 0]) * np.cos(f * xy[:, 1])
    return np.concatenate([xy, z[:, None]], -1).astype(np.float32)


def _perturb(R, t, rng, deg, trans):
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    a = np.radians(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]], np.float32)
    dR = np.eye(3, dtype=np.float32) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
    return (dR @ R).astype(np.float32), (t + rng.standard_normal(3).astype(np.float32) * trans)


def _multiscale_both(arrays, tol, **kw):
    ref = jicp.icp_refine_multiscale(*(jnp.asarray(a) for a in arrays), **kw)
    got = ticp.icp_refine_multiscale(*(torch.from_numpy(a) for a in arrays), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=tol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=tol)
    assert got[2].shape == ref[2].shape
    return got


def test_multiscale_icp_matches_jax_on_the_basin_case():
    """JAX's rippled-surface case (30 deg / 40 cm off; the pyramid converges
    where fine-only plane ICP does not), with coarse scales that shrink."""
    r = np.random.default_rng(3)
    src = _surface(r, 1024)[None]
    R = random_rotation(r).astype(np.float32)
    t = (r.standard_normal(3) * 0.1).astype(np.float32)
    tgt = (_surface(r, 1024) @ R.T + t)[None].astype(np.float32)
    R0, t0 = _perturb(R, t, r, deg=30.0, trans=0.4)
    Rm, tm, wm = _multiscale_both((src, tgt, R0[None], t0[None]), 1e-4,
                                  voxel_sizes=((0.5, 256), (0.2, 512), 0.0),
                                  iters=(15, 15, 15), mode="plane", normals_k=12)
    assert np.degrees(np.linalg.norm(Rm[0].numpy() - R) / np.sqrt(2)) < 1.0
    assert np.linalg.norm(tm[0].numpy() - t) < 0.01 and wm.shape == (1, 1024)


def test_multiscale_icp_matches_jax_on_an_easy_problem(rng):
    src = rng.standard_normal((2, 256, 3)).astype(np.float32)
    poses = [(random_rotation(rng).astype(np.float32),
              (rng.standard_normal(3) * 0.5).astype(np.float32)) for _ in range(2)]
    tgt = np.stack([s @ R.T + t for s, (R, t) in zip(src, poses)]).astype(np.float32)
    init = [_perturb(R, t, rng, 8.0, 0.1) for (R, t) in poses]
    R0 = np.stack([p[0] for p in init])
    t0 = np.stack([p[1] for p in init]).astype(np.float32)
    R, t, _ = _multiscale_both((src, tgt, R0, t0), 1e-5, voxel_sizes=(0.6, 0.0), iters=(8, 12))
    for b, (Rg, tg) in enumerate(poses):
        assert np.linalg.norm(R[b].numpy() - Rg) / np.sqrt(2) < 2e-3
        assert np.linalg.norm(t[b].numpy() - tg) < 1e-3


def test_multiscale_raw_fields_apply_only_at_the_raw_scale(rng):
    """tgt_normals sized for the raw cloud reach the 0.0 scale only: the
    pyramid equals the coarse scale (normals of its centroids) followed by
    the raw scale with the given field, and equals JAX's pyramid. The coarse
    scale keeps 64 of the 67 occupied cells (`num_out`): at num_out = N the
    padding copies each centroid ~4 times, so a 12-neighborhood holds 3
    distinct points whose PCA normal is ill-conditioned (eigenvalue ratio
    ~2e-3), and there the JAX package's and the port's float32 normals each
    sit 3e-3 to 1e-2 from the float64 one."""
    src = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    src[:, 2] = 0.05 * np.sin(3 * src[:, 0]) * np.cos(2 * src[:, 1])
    R = random_rotation(rng).astype(np.float32)
    t = (rng.standard_normal(3) * 0.1).astype(np.float32)
    tgt = (src @ R.T + t).astype(np.float32)
    n_tgt = np.array(jicp.estimate_normals(jnp.asarray(tgt)[None], k=12))
    eye, z = np.eye(3, dtype=np.float32)[None], np.zeros((1, 3), np.float32)
    kw = dict(voxel_sizes=((0.3, 64), 0.0), iters=(3, 3), mode="plane", normals_k=12)
    ref = jicp.icp_refine_multiscale(jnp.asarray(src)[None], jnp.asarray(tgt)[None],
                                     jnp.asarray(eye), jnp.asarray(z),
                                     tgt_normals=jnp.asarray(n_tgt), **kw)
    s_, g_ = torch.from_numpy(src)[None], torch.from_numpy(tgt)[None]
    e_, z_, n_ = torch.from_numpy(eye), torch.from_numpy(z), torch.from_numpy(n_tgt)
    Rm, tm, _ = ticp.icp_refine_multiscale(s_, g_, e_, z_, tgt_normals=n_, **kw)
    s, smask, _ = tvoxel(s_, 0.3, num_out=64)
    g, _, _ = tvoxel(g_, 0.3, num_out=64)
    Rc, tc, _ = ticp.icp_refine(s, g, e_, z_, iters=3, mode="plane", normals_k=12,
                                prior_weights=smask.float())
    Rf, tf, _ = ticp.icp_refine(s_, g_, Rc, tc, iters=3, mode="plane", normals_k=12,
                                tgt_normals=n_)
    np.testing.assert_allclose(Rm.numpy(), Rf.numpy(), atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), tf.numpy(), atol=1e-6)
    np.testing.assert_allclose(Rm.numpy(), np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(ref[1]), atol=1e-5)


def test_multiscale_icp_validation():
    src = torch.zeros(1, 8, 3)
    eye, z = torch.eye(3)[None], torch.zeros(1, 3)
    with pytest.raises(ValueError, match="at least one scale"):
        ticp.icp_refine_multiscale(src, src, eye, z, voxel_sizes=())
    with pytest.raises(ValueError, match="entries"):
        ticp.icp_refine_multiscale(src, src, eye, z, voxel_sizes=(0.1, 0.0), iters=(3,))
    with pytest.raises(ValueError, match="num_out"):
        ticp.icp_refine_multiscale(src, src, eye, z, voxel_sizes=((0.0, 4),))


@pytest.mark.parametrize("icp_mode,voxels", [
    ("plane", (0.15, 0.0)), ("plane", ((0.15, 256), 0.0)), ("symmetric", (0.15, 0.0)),
], ids=["plane", "plane-num_out", "symmetric"])
def test_register_fpfh_voxel_pyramid_matches_jax(bumpy, monkeypatch, icp_mode, voxels):
    """The fused path with a voxel pyramid at 60 ICP steps a scale, on the
    independently sampled pair of tests/test_torch_registration.py (seed 3,
    about 3 points an occupied 0.15 m cell): both sides recover the pose and
    agree at that file's gate."""
    monkeypatch.setattr(treg, "gumbel_noise", jax_noise)
    src, tgt, R, t = _pair(bumpy, 3)
    kw = dict(n_points=N_POINTS, window=WINDOW, knn_method="fused", knn_packed="chunked",
              icp_iters=60, icp_voxels=voxels, icp_mode=icp_mode)
    ref = jreg.register_fpfh(src, tgt, **kw)
    got = treg.register_fpfh(src, tgt, device="cpu", **kw)
    _agree(got, ref)
    assert np.degrees(np.linalg.norm(got[0] - R) / np.sqrt(2)) < 0.5
    assert np.abs(got[1] - t).max() < 5e-3
