"""Port vs JAX: the checkpoint-free pipeline end to end — `register_fpfh`
with knn_method='fused' (k-NN B1 or B4, then SPFH B5, in their plain
versions here) and `register_fpfh_batch` — with JAX's own Gumbel noise
handed to the port's triplet draw (per-pair keys from
`jax.random.split(PRNGKey(seed), B)` in the batch, as the reference does).

Tolerances: ‖ΔR‖_F/√2 and max|Δt| within 1e-4, 99% of the per-point
weights within 1e-3, the pose covariance within 1e-3 relative. The two
sides' descriptors differ at fp noise (the normals' moments are summed in
other orders, ~1e-5), which moves a few edges across histogram bin
boundaries and so the coarse pose slightly. When src and tgt sample the
surface at the same points, ICP then lands on the same pose (measured
~1e-7 apart). When they sample it independently, plane ICP does not settle
in 10 steps (nor always in 60): its end pose wanders at the 1e-3 level
with its start, both sides recover the ground truth to ~0.1 deg, and the
gap to JAX measured 1.4e-4 to 6.9e-3 on such pairs at n=512. So the
parity cases use same-point pairs at the default knobs, and the
independent pair is held to the ground truth, plus one pair (seed 3) on
which 60 ICP steps do settle, to 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu import registration as jreg
from se3_equi_graph_registration_tpu.data.synthetic import random_rotation
from se3_equi_graph_registration_tpu_torch import registration as treg
from se3_equi_graph_registration_tpu_torch.parallel.mesh import make_mesh

N_POINTS, WINDOW = 512, 256


def jax_noise(seed, shape, batch=None):
    """JAX's Gumbel noise for register_fpfh (PRNGKey(seed)) and for
    register_fpfh_batch (the split keys), as a CPU tensor."""
    if batch is None:
        return torch.from_numpy(np.array(jax.random.gumbel(jax.random.PRNGKey(seed), shape)))
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    return torch.from_numpy(np.stack([np.array(jax.random.gumbel(k, shape)) for k in keys]))


@pytest.fixture
def same_noise_as_jax(monkeypatch):
    monkeypatch.setattr(treg, "gumbel_noise", jax_noise)


@pytest.fixture(scope="module")
def bumpy():
    """The Gaussian-bump height field of tests/test_global_registration.py:
    locally distinctive geometry."""
    rng = np.random.default_rng(0)
    centers = rng.uniform(-1.6, 1.6, (30, 2))
    amps = rng.uniform(-0.35, 0.35, 30)
    widths = rng.uniform(0.08, 0.3, 30)

    def surf(rng2, n):
        xy = np.stack([rng2.uniform(-1, 1, n), rng2.uniform(-1, 1, n)], -1)
        z = np.zeros(n)
        for (cx, cy), a, w in zip(centers, amps, widths):
            z += a * np.exp(-((xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2) / w)
        pts = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
        return pts + rng2.standard_normal(pts.shape).astype(np.float32) * 0.002

    return surf


def _pair(surf, seed, same_points=False):
    rng = np.random.default_rng(seed)
    src = surf(rng, N_POINTS)
    R = random_rotation(rng).astype(np.float32)
    t = (rng.standard_normal(3) * 0.3).astype(np.float32)
    tgt = (src if same_points else surf(rng, N_POINTS)) @ R.T + t
    return src, tgt.astype(np.float32), R, t


def _agree(got, ref):
    (Rg, tg, ig), (Rr, tr, ir) = got, ref
    dR = np.linalg.norm(Rg - Rr, axis=(-2, -1)).max() / np.sqrt(2)
    dt = np.abs(tg - tr).max()
    w_ok = np.isclose(ig["weights"], ir["weights"], rtol=0, atol=1e-3).mean()
    assert dR <= 1e-4 and dt <= 1e-4 and w_ok >= 0.99, (dR, dt, w_ok)
    np.testing.assert_allclose(ig["pose_covariance"], ir["pose_covariance"], rtol=1e-3,
                               atol=1e-9)


@pytest.mark.parametrize("knobs", [
    dict(knn_packed="chunked", ransac_branches=4),
    dict(knn_packed="chunked", ransac_branches=1),
    dict(knn_packed=True, ransac_branches=4),
    dict(knn_packed=False, ransac_branches=1),
    dict(knn_packed="chunked", coarse="spectral"),
], ids=["chunked-4", "chunked-1", "packed-4", "exact-1", "chunked-spectral"])
def test_register_fpfh_fused_matches_jax(bumpy, same_noise_as_jax, knobs):
    src, tgt, R, t = _pair(bumpy, 4, same_points=True)
    kw = dict(n_points=N_POINTS, window=WINDOW, knn_method="fused", **knobs)
    ref = jreg.register_fpfh(src, tgt, **kw)
    got = treg.register_fpfh(src, tgt, device="cpu", **kw)
    _agree(got, ref)
    np.testing.assert_array_equal(got[2]["indices"], ref[2]["indices"])
    assert np.linalg.norm(got[0] - R) / np.sqrt(2) < 1e-4 and np.abs(got[1] - t).max() < 1e-4


def test_register_fpfh_independent_sampling(bumpy, same_noise_as_jax):
    """src and tgt sample the surface at different points: both sides
    recover the pose (0.5 deg, 5 mm, the reference's bar), and where ICP
    settles (seed 3, 60 steps) they agree to 1e-4."""
    src, tgt, R, t = _pair(bumpy, 3)
    kw = dict(n_points=N_POINTS, window=WINDOW, knn_method="fused", knn_packed="chunked")
    for res in (jreg.register_fpfh(src, tgt, **kw),
                treg.register_fpfh(src, tgt, device="cpu", **kw)):
        assert np.degrees(np.linalg.norm(res[0] - R) / np.sqrt(2)) < 0.5
        assert np.abs(res[1] - t).max() < 5e-3
    kw["icp_iters"] = 60
    _agree(treg.register_fpfh(src, tgt, device="cpu", **kw), jreg.register_fpfh(src, tgt, **kw))


def test_register_fpfh_batch_matches_jax_and_single_calls(bumpy, monkeypatch):
    pairs = [_pair(bumpy, s, same_points=True) for s in (5, 6)]
    src = np.stack([p[0] for p in pairs])
    tgt = np.stack([p[1] for p in pairs])
    kw = dict(window=WINDOW, knn_method="fused", knn_packed="chunked")
    monkeypatch.setattr(treg, "gumbel_noise", jax_noise)
    Rr, tr, ir = jreg.register_fpfh_batch(src, tgt, seed=7, **kw)
    Rg, tg, ig = treg.register_fpfh_batch(src, tgt, seed=7, device="cpu", **kw)
    for b in range(2):
        _agree((Rg[b], tg[b], {k: v[b] for k, v in ig.items()}),
               (Rr[b], tr[b], {k: v[b] for k, v in ir.items()}))
    # one batch equals its pairs run one by one, given each pair's noise
    noise = jax_noise(7, (512, 3, 512), 2)
    for b in range(2):
        monkeypatch.setattr(treg, "gumbel_noise", lambda seed, shape, batch=None, b=b: noise[b])
        Rs, ts, info = treg.register_fpfh(src[b], tgt[b], n_points=N_POINTS, device="cpu", **kw)
        assert np.abs(Rs - Rg[b]).max() <= 1e-5 and np.abs(ts - tg[b]).max() <= 1e-5
        assert np.isclose(info["weights"], ig["weights"][b], rtol=0, atol=1e-3).mean() >= 0.99


def test_register_fpfh_window_method_matches_jax(bumpy):
    """knn_method='window' (B1 exact keys in the window, gather FPFH, atan2)
    with the deterministic spectral stage."""
    src, tgt, _, _ = _pair(bumpy, 4, same_points=True)
    kw = dict(n_points=N_POINTS, window=WINDOW, knn_method="window", coarse="spectral")
    _agree(treg.register_fpfh(src, tgt, device="cpu", **kw), jreg.register_fpfh(src, tgt, **kw))


def test_register_fpfh_rejects_what_is_not_ported(bumpy):
    src, tgt, _, _ = _pair(bumpy, 3)
    with pytest.raises(ValueError, match="must end at 0.0"):
        treg.register_fpfh(src, tgt, n_points=N_POINTS, icp_voxels=(0.1, 0.05), device="cpu")
    with pytest.raises(TypeError, match="mesh must be"):
        treg.register_fpfh_batch(src[None], tgt[None], mesh=object(), device="cpu")
    # a mesh with a 'point' axis splits the pairs over its 'data' axis (here
    # none: one rank) and runs them whole on every point rank
    _agree(treg.register_fpfh_batch(src[None], tgt[None], device="cpu",
                                    mesh=make_mesh({"point": 1})),
           treg.register_fpfh_batch(src[None], tgt[None], device="cpu"))
    with pytest.raises(ValueError, match="knn_packed"):
        treg.register_fpfh(src, tgt, n_points=N_POINTS, knn_packed="yes", device="cpu")
    with pytest.raises(ValueError, match="multiples of"):
        treg.register_fpfh(src, tgt, n_points=500, knn_method="fused", device="cpu")
    with pytest.raises(TypeError):
        treg.register_fpfh_batch(src[None], tgt[None], bogus=1, device="cpu")
