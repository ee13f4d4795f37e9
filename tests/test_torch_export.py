"""`torch.export` artifacts of the port, on the CPU: the Registrar's
(`export_compiled`/`load_exported`, weights passed at call time) and the
checkpoint-free pipeline's, and the kernels' custom ops.

Tolerances:
- loaded artifact against the live call of the same port, same inputs: the
  same operations in the same order, so equal up to the CPU's fp32 reduction
  kernels, which may split a sum another way between two calls; R, t, the
  weights and the similarity mean within 1e-6, the covariance within 1e-6
  relative to its largest entry (measured equal);
- the port's loaded artifact against JAX's, same weights and batch: the
  accurate serving gate of tests/test_torch_serving.py (R and t 1e-4,
  covariance 1e-3 relative, similarity mean 1e-4 relative).

On the CPU the kernel wrappers take their plain versions, so a CPU artifact
holds no custom op; chip_smoke.py exports, loads and counts the ops' launches
on the card. Here the ops' fake implementations are traced under a
FakeTensorMode with fake CUDA tensors, which this CPU build of torch makes.
The pipeline is exported at knn_method='approx' with the quaternion Kabsch
(the JAX test's setting) and at 'fused'/'chunked' with the SVD Kabsch, to
keep the second export short: the quaternion Kabsch unrolls its 60 power
steps a solve into the graph.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch_port_util import jax_model_params

from se3_equi_graph_registration_tpu import serving as jserving
from se3_equi_graph_registration_tpu.data.synthetic import make_pair_batch
from se3_equi_graph_registration_tpu.train import engine as jengine
from se3_equi_graph_registration_tpu_torch import registration as tregistration
from se3_equi_graph_registration_tpu_torch import serving as tserving
from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn, spfh
from se3_equi_graph_registration_tpu_torch.ops.ransac import gumbel_noise
from se3_equi_graph_registration_tpu_torch.train import engine as tengine
from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

N, C = 128, 16
SMALL = dict(num_nodes=N, k=8, in_node_nf=C, hidden_nf=32, top_k=32)


def _batch(seed):
    """One `make_pair_batch` request (70% inliers, noisy): its residuals give
    a well-conditioned covariance, which a noise-free copy would not."""
    pb = make_pair_batch(np.random.default_rng(seed), batch=1, n=N, feat_dim=C)
    return {"src_pts": pb.src_pts, "src_feat": pb.src_feat, "tgt_pts": pb.tgt_pts,
            "tgt_feat": pb.tgt_feat, "labels": np.ones((1, N), np.float32)}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The JAX export test's model (tests/test_serving.py:192) with the
    serving head, its weights in both packages, and both packages'
    artifacts of its Registrar."""
    root = tmp_path_factory.mktemp("export")
    _, params = jax_model_params(jengine.EngineConfig(**SMALL), "eval_fusion")
    jreg = jserving.Registrar(params, jengine.EngineConfig(**SMALL), head_mode="eval_fusion")
    jreg.export_compiled(str(root / "registrar.jaxexport"), batch=1)
    treg = tserving.Registrar(params_from_jax(params), tengine.EngineConfig(**SMALL),
                              head_mode="eval_fusion", device="cpu")
    path = str(root / "registrar.pt2")
    size = treg.export_compiled(path, batch=1)
    assert size > 0 and os.path.getsize(path) == size
    return dict(params=params, jreg=jreg, treg=treg, path=path,
                jfn=jserving.Registrar.load_exported(str(root / "registrar.jaxexport")),
                tfn=tserving.Registrar.load_exported(path))


def _weights(reg):
    return {k: v.detach() for k, v in reg.model.state_dict().items()}


def _as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_loaded_registrar_artifact_equals_register(exported):
    reg = exported["treg"]
    batch = _batch(0)
    R, t, sim, cov = (a.numpy() for a in exported["tfn"](_weights(reg), _as_torch(batch)))
    Rr, tr, info = reg.register(batch["src_pts"], batch["src_feat"], batch["tgt_pts"],
                                batch["tgt_feat"])
    np.testing.assert_allclose(R, Rr, atol=1e-6)
    np.testing.assert_allclose(t, tr, atol=1e-6)
    assert abs(float(sim.mean()) - info["similarity_mean"]) <= 1e-6 * abs(info["similarity_mean"])
    cr = info["pose_covariance"]
    np.testing.assert_allclose(cov, cr, rtol=0, atol=1e-6 * np.abs(cr).max())


def test_cluster_registrar_artifact_equals_register(tmp_path):
    """A 'cluster' Registrar (the plain EGNN, segment sums onto the
    neighbours) exports and loads as the fused path's does; the artifact
    equals `register()` (same tolerance as above; measured equal)."""
    cfg = tengine.EngineConfig(**SMALL, direction="cluster")
    _, params = jax_model_params(jengine.EngineConfig(**SMALL, direction="cluster"),
                                 "eval_fusion")
    reg = tserving.Registrar(params_from_jax(params), cfg, head_mode="eval_fusion",
                             device="cpu")
    path = str(tmp_path / "cluster.pt2")
    reg.export_compiled(path, batch=1)
    fn = tserving.Registrar.load_exported(path)
    batch = _batch(3)
    R, t, _, _ = (a.numpy() for a in fn(_weights(reg), _as_torch(batch)))
    Rr, tr, _ = reg.register(batch["src_pts"], batch["src_feat"], batch["tgt_pts"],
                             batch["tgt_feat"])
    np.testing.assert_allclose(R, Rr, atol=1e-6)
    np.testing.assert_allclose(t, tr, atol=1e-6)


def test_loaded_registrar_artifact_equals_jax(exported):
    batch = _batch(1)
    R, t, sim, cov = (a.numpy() for a in
                      exported["tfn"](_weights(exported["treg"]), _as_torch(batch)))
    jR, jt, jsim, jcov = (np.asarray(a) for a in jax.device_get(exported["jfn"](
        exported["params"], {k: jnp.asarray(v) for k, v in batch.items()})))
    assert np.all(np.linalg.norm(R - jR, axis=(-2, -1)) / np.sqrt(2) < 1e-4)
    np.testing.assert_allclose(t, jt, atol=1e-4)
    np.testing.assert_allclose(cov, jcov, rtol=1e-3, atol=1e-3 * np.abs(jcov).max())
    np.testing.assert_allclose(sim, jsim, rtol=1e-4)


def test_one_artifact_serves_other_weights(exported):
    _, other = jax_model_params(jengine.EngineConfig(**SMALL), "eval_fusion", seed=1)
    reg = tserving.Registrar(params_from_jax(other), tengine.EngineConfig(**SMALL),
                             head_mode="eval_fusion", device="cpu")
    batch = _batch(2)
    R, t, sim, _ = (a.numpy() for a in exported["tfn"](_weights(reg), _as_torch(batch)))
    Rr, tr, info = reg.register(batch["src_pts"], batch["src_feat"], batch["tgt_pts"],
                                batch["tgt_feat"])
    np.testing.assert_allclose(R, Rr, atol=1e-6)
    np.testing.assert_allclose(t, tr, atol=1e-6)
    want = info["similarity_mean"]
    assert abs(float(sim.mean()) - want) <= 1e-6 * abs(want)
    _, _, sim0, _ = exported["tfn"](_weights(exported["treg"]), _as_torch(batch))
    assert abs(float(sim0.mean()) - want) > 1e-2 * abs(want)   # the weights given are used


@pytest.mark.parametrize("platforms", [("tpu",), ("cuda",), ("cpu", "cuda"), "cpu"])
def test_export_takes_one_platform_the_registrar_has(exported, platforms, tmp_path):
    with pytest.raises(ValueError, match="one device's graph"):
        exported["treg"].export_compiled(str(tmp_path / "x.pt2"), platforms=platforms)


def test_loaded_call_runs_in_full_fp32_and_restores_the_callers_setting(monkeypatch):
    seen = []

    class Program:
        def module(self):
            return lambda *a: seen.append(torch.get_float32_matmul_precision()) or a

    monkeypatch.setattr(torch.export, "load", lambda path: Program())
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        for load in (tserving.Registrar.load_exported, tregistration.load_exported):
            assert load("artifact.pt2")(1, 2) == (1, 2)
            assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen == ["highest", "highest"]


def _bumpy_pairs(b, n):
    """Two bump-field clouds a pair (tests/test_global_registration.py)."""
    grng = np.random.default_rng(0)
    centers, amps = grng.uniform(-1.6, 1.6, (30, 2)), grng.uniform(-0.35, 0.35, 30)
    widths = grng.uniform(0.08, 0.3, 30)
    rng = np.random.default_rng(5)

    def surf():
        xy = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)], -1)
        z = sum(a * np.exp(-((xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2) / w)
                for (cx, cy), a, w in zip(centers, amps, widths))
        return np.concatenate([xy, z[:, None]], -1).astype(np.float32)

    src = np.stack([surf() for _ in range(b)])
    tgt = np.stack([surf() + np.float32([0.1, -0.05, 0.02]) for _ in range(b)])
    return src, tgt


@pytest.mark.parametrize("knobs", [
    dict(knn_method="approx"),
    dict(knn_method="fused", knn_packed="chunked", window=256, solver="svd"),
], ids=["approx", "fused-chunked"])
def test_pipeline_artifact_equals_register_fpfh_batch(knobs, tmp_path):
    n, b, seed = 256, 2, 3
    kw = dict(icp_iters=4, hypotheses=128, top_m=128, **knobs)
    path = str(tmp_path / "register.pt2")
    size = tregistration.export_compiled(path, batch=b, n_points=n, platforms=("cpu",), **kw)
    assert size > 0 and os.path.getsize(path) == size
    src, tgt = _bumpy_pairs(b, n)
    R, t, info = tregistration.register_fpfh_batch(src, tgt, seed=seed, device="cpu", **kw)
    fn = tregistration.load_exported(path)
    noise = torch.as_tensor(gumbel_noise(seed, (128, 3, 128), b))
    got = [a.numpy() for a in fn(torch.from_numpy(src), torch.from_numpy(tgt), noise)]
    want = (R, t, info["weights"], info["pose_covariance"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * max(1.0, np.abs(w).max()))


def test_pipeline_export_rejects_unknown_knobs_and_platforms(tmp_path):
    with pytest.raises(TypeError, match="unknown export_compiled knobs"):
        tregistration.export_compiled(str(tmp_path / "x.pt2"), platforms=("cpu",), bogus=1)
    with pytest.raises(ValueError, match="one device's graph"):
        tregistration.export_compiled(str(tmp_path / "x.pt2"), platforms=("tpu",))


def test_registrar_artifact_is_traced_from_the_weights_it_is_given(exported):
    """No weight and no kernel layout is baked in: the program holds no
    parameter, buffer or constant tensor."""
    program = torch.export.load(exported["path"])
    assert not program.state_dict and not program.constants


def test_an_export_under_the_profiler_holds_no_profiler_op(exported, monkeypatch, tmp_path):
    """The forward's named spans step aside while `torch.export` traces:
    exported with a profiler recording, no span is opened and the program
    holds no profiler op."""
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    path = str(tmp_path / "profiled.pt2")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        exported["treg"].export_compiled(path, batch=1)
    assert opened == []
    targets = [str(n.target) for n in torch.export.load(path).graph.nodes]
    assert not [t for t in targets if "profiler" in t or "record_function" in t]


def test_fake_implementations_give_the_kernels_shapes_on_fake_cuda_tensors():
    """Each op traced under a FakeTensorMode through its public wrapper (the
    wrapper's checks and variant choice run as on the card): outputs on the
    input's CUDA device with the kernels' shapes and dtypes."""
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN

    b, n, k = 2, 256, 16
    with FakeTensorMode():
        x = torch.empty(b, n, 3, device="cuda")
        nbr = knn.knn_window(x, k, 128, 256, packed=True)
        assert (nbr.shape, nbr.dtype, nbr.device.type) == ((b, n, k), torch.int32, "cuda")
        nbr = knn.knn_window(x, k, 128, None)
        assert (nbr.shape, nbr.dtype) == ((b, n, k), torch.int32)
        nbr = knn.knn_chunked(x, 60, 128, 256)
        assert (nbr.shape, nbr.dtype) == ((b, n, 60), torch.int32)
        out, dist = spfh.spfh(x, torch.empty(b, n, 3, device="cuda"), nbr, 128, 256)
        assert out.shape == (b, n, 33) and dist.shape == (b, n, 60)
        assert out.dtype == dist.dtype == torch.float32 and out.device.type == "cuda"
    for c, heads in ((32, 4), (33, 1)):
        layer = EGNN(in_node_nf=c, hidden_nf=c, out_node_nf=c, n_layers=1, num_heads=heads)
        p = egcl.params_from_layer(layer.gcl_0)
        with FakeTensorMode(allow_non_fake_inputs=True):
            h, x = torch.empty(b, n, c, device="cuda"), torch.empty(b, n, 3, device="cuda")
            nbr = torch.empty(b, n, k, dtype=torch.int32, device="cuda")
            for accurate in (True, False):
                h2, x2 = egcl.egcl_layer(h, x, nbr, p, accurate)
                assert h2.shape == h.shape and x2.shape == x.shape
                *_, agg = egcl.egcl_layer(h, x, nbr, p, accurate, return_aggm=True)
                assert agg.shape == h.shape and agg.device.type == "cuda"
