"""`Registrar.register_raw` of the port against the JAX package's, on the
CPU, at a small KITTI-style model (in_node_nf = hidden = 33, one head, N=256,
2 layers, top_k = N; the kitti preset's EngineConfig otherwise: exact k-NN,
fp32 EGCL, SVD Kabsch) on the Gaussian-bump surface of
tests/test_global_registration.py, sampled twice under a random pose.

Each stage is held apart, the JAX side recomputed with JAX's own functions
in the order of its register_raw (serving.py:290-310):
- the fitted clouds: equal (one numpy generator, consumed pair by pair,
  source then target, on both sides);
- the descriptors (L2-normalized FPFH-33 rows): at least 98% of the entries
  within 1e-3 (measured 98.3-99.7%). The port's gather FPFH and JAX's can
  put an edge within fp noise of a bin boundary in the next bin (XLA
  contracts a*b - c*d into FMAs, the port rounds each op; PERF.md),
  and the port gives the source pick's near-ties to the center
  (`ops/fpfh.PICK_TIE`), where JAX's pick falls by rounding.
  At N=256 and K=60 one such edge moves its center's row and the ~60 rows
  that average it, a quarter of the cloud, and renormalizing those rows
  moves each of their entries a little;
- the matches: at least 95% of the rows equal (measured 98.0-99.2%), for
  the same reason; so the poses of the two register_raw calls differ by
  more than fp noise, and are not compared;
- the pose: the port's register() on JAX's fitted, matched arrays against
  JAX's register_raw, R and t within 1e-4 (the accurate serving gate);
- the port's register_raw equals its register() on its own matched arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation
from torch_port_util import jax_model_params

from se3_equi_graph_registration_tpu import registration as jregistration
from se3_equi_graph_registration_tpu import serving as jserving
from se3_equi_graph_registration_tpu.data.sampling import fit_to_count
from se3_equi_graph_registration_tpu.ops import fpfh as jfpfh
from se3_equi_graph_registration_tpu.train import engine as jengine
from se3_equi_graph_registration_tpu_torch import serving as tserving
from se3_equi_graph_registration_tpu_torch.train import engine as tengine
from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

N = 256
KITTI_SMALL = dict(num_nodes=N, in_node_nf=33, hidden_nf=33, n_layers=2, num_heads=1,
                   top_k=N)


def _surface(rng, n):
    """The bump field of tests/test_global_registration.py::bumpy."""
    grng = np.random.default_rng(0)
    centers = grng.uniform(-1.6, 1.6, (30, 2))
    amps = grng.uniform(-0.35, 0.35, 30)
    widths = grng.uniform(0.08, 0.3, 30)
    xy = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)], -1)
    z = np.zeros(n)
    for (cx, cy), a, w in zip(centers, amps, widths):
        z += a * np.exp(-((xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2) / w)
    pts = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
    return pts + rng.standard_normal(pts.shape).astype(np.float32) * 0.002


def _pair(seed, n):
    rng = np.random.default_rng(seed)
    R = Rotation.from_euler("xyz", [0.3, -0.2, 0.5]).as_matrix().astype(np.float32)
    t = np.asarray([0.1, -0.2, 0.05], np.float32)
    return _surface(rng, n), _surface(rng, n) @ R.T + t


@pytest.fixture(scope="module")
def registrars():
    _, params = jax_model_params(jengine.EngineConfig(**KITTI_SMALL), "eval_fusion")
    ref = jserving.Registrar(params, jengine.EngineConfig(**KITTI_SMALL))
    got = tserving.Registrar(params_from_jax(params), tengine.EngineConfig(**KITTI_SMALL),
                             device="cpu")
    return ref, got


def _jax_stages(pairs, voxel, seed):
    """JAX register_raw's host fitting, descriptors and matches."""
    rng = np.random.default_rng(seed)

    def descriptors(cloud):
        p = np.asarray(cloud, np.float32)
        if voxel > 0:
            p = jfpfh.voxel_downsample(p, voxel)
        p, _ = fit_to_count(p, N, rng)
        xj = jnp.asarray(p)
        nrm = jfpfh.estimate_normals(xj, k=30, orient="local")
        f = np.asarray(jfpfh.fpfh(xj, nrm, k=60))
        return p, (f / (np.linalg.norm(f, axis=1, keepdims=True) + 1e-6)).astype(np.float32)

    out = []
    for src, tgt in pairs:
        sp, sf = descriptors(src)
        tp, tf = descriptors(tgt)
        j = np.asarray(jregistration.match_features(jnp.asarray(sf), jnp.asarray(tf))[0])
        out.append((sp, sf, tp, tf, j))
    return out


@pytest.mark.parametrize("voxel,n_raw", [(0.0, 300), (0.06, 900)], ids=["raw", "voxel"])
def test_register_raw_matches_jax_stage_by_stage(registrars, voxel, n_raw):
    ref, got = registrars
    pairs = [_pair(1, n_raw), _pair(2, n_raw)]
    src, tgt = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    want = _jax_stages(pairs, voxel, seed=4)
    c = {k: v.numpy() for k, v in
         got.raw_correspondences(src, tgt, voxel=voxel, seed=4).items()}
    for i, (sp, sf, tp, tf, j) in enumerate(want):
        np.testing.assert_array_equal(c["src_pts"][i], sp)
        np.testing.assert_array_equal(c["tgt_pts"][i], tp[c["matches"][i]])
        for f_got, f_want in ((c["src_feat"][i], sf), (c["tgt_feat"][i], tf[c["matches"][i]])):
            assert np.mean(np.abs(f_got - f_want) <= 1e-3) >= 0.98
        assert np.mean(c["matches"][i] == j) >= 0.95
    Rr, tr, _ = ref.register_raw(src, tgt, voxel=voxel, seed=4)
    stack = lambda q: np.stack([w[q] for w in want])
    Rg, tg, _ = got.register(stack(0), stack(1), np.stack([w[2][w[4]] for w in want]),
                             np.stack([w[3][w[4]] for w in want]), seed=4)
    assert np.all(np.linalg.norm(Rg - np.asarray(Rr), axis=(-2, -1)) / np.sqrt(2) < 1e-4)
    np.testing.assert_allclose(tg, np.asarray(tr), atol=1e-4)
    Rw, tw, info = got.register_raw(src, tgt, voxel=voxel, seed=4)
    Rs, ts, own = got.register(c["src_pts"], c["src_feat"], c["tgt_pts"], c["tgt_feat"], seed=4)
    np.testing.assert_array_equal(Rw, Rs)
    np.testing.assert_array_equal(tw, ts)
    assert info["pose_covariance"].shape == (2, 6, 6)


def test_register_raw_squeezes_a_single_pair(registrars):
    ref, got = registrars
    src, tgt = _pair(3, 300)
    Rr, tr, ir = ref.register_raw(src, tgt, seed=1)
    Rg, tg, ig = got.register_raw(src, tgt, seed=1)
    assert Rg.shape == (3, 3) and tg.shape == (3,) and ig["pose_covariance"].shape == (6, 6)
    assert isinstance(ig["similarity_mean"], float) and set(ig) == set(ir)
    Rb, tb, _ = got.register_raw(src[None], tgt[None], seed=1)
    np.testing.assert_array_equal(Rg, Rb[0])
    np.testing.assert_array_equal(tg, tb[0])


def test_register_raw_needs_a_33_feature_model():
    kw = dict(num_nodes=128, k=8, in_node_nf=32, hidden_nf=32, n_layers=1, top_k=32)
    _, params = jax_model_params(jengine.EngineConfig(**kw), "eval_fusion")
    reg = tserving.Registrar(params_from_jax(params), tengine.EngineConfig(**kw),
                             device="cpu")
    pts = np.zeros((128, 3), np.float32)
    with pytest.raises(ValueError, match="in_node_nf=32") as got:
        reg.register_raw(pts, pts)
    with pytest.raises(ValueError) as want:
        jserving.Registrar(params, jengine.EngineConfig(**kw)).register_raw(pts, pts)
    assert str(got.value) == str(want.value)
