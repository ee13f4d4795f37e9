"""Port vs JAX: the robust evaluation path. The port's Registrar and the JAX
Registrar on the same `params_from_jax` weights and numpy requests at a
small `robust_eval_config` (N=512, k=16, C=16, 2 layers, 2 heads,
top_k=32): the head, spectral reweighting, 5 IRLS steps, then ICP
single-scale or over a voxel pyramid; and `make_eval_step` metric by
metric under the same configs.

Tolerances, those of tests/test_torch_serving.py::_compare:
- accurate (egnn_accurate=True on both sides): R within 1e-4
  (‖ΔR‖_F/√2), t within 1e-4, covariance 1e-3 relative, similarity mean
  1e-4 relative (measured ≤ 1.4e-6, 1.1e-6, 1.1e-4 and 4.2e-6);
- fast: the JAX CPU run computes fast mode in float32 while the port rounds
  MLP operands to bf16: R and t within 2e-2, similarity mean 2e-2 relative
  (measured 1.3e-6, 1.7e-6 and 1.4e-3: the sharp weighting, spectral and
  IRLS land both on the same inliers).
- eval step: RTE to 1e-3 cm, RRE to 0.05° (arccos near 0°), recall and
  precision equal, as tests/test_torch_engine.py.
"""
import jax
import numpy as np
import pytest
import torch
from test_torch_serving import _compare
from torch_port_util import jax_model_params

from se3_equi_graph_registration_tpu import serving as jserving
from se3_equi_graph_registration_tpu.data.synthetic import make_pair_batch
from se3_equi_graph_registration_tpu.train import engine as jengine
from se3_equi_graph_registration_tpu_torch import serving as tserving
from se3_equi_graph_registration_tpu_torch.train import engine as tengine
from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

N, C = 512, 16
SMALL = dict(num_nodes=N, k=16, in_node_nf=C, hidden_nf=C, n_layers=2, num_heads=2, top_k=32)
STAGES = {"spectral+irls": {}, "icp": dict(icp_iters=10),
          "icp-pyramid": dict(icp_iters=10, icp_voxels=(0.3, 0.0)),
          "icp-plane": dict(icp_iters=10, icp_mode="plane")}


def _pairs():
    return make_pair_batch(np.random.default_rng(11), batch=2, n=N, feat_dim=C)


def _weights(accurate):
    return jax_model_params(jengine.robust_eval_config(**SMALL, egnn_accurate=accurate),
                            "eval_fusion")[1]


@pytest.fixture(scope="module")
def weights():
    return {acc: _weights(acc) for acc in (True, False)}


@pytest.mark.parametrize("accurate", [True, False], ids=["accurate", "fast"])
@pytest.mark.parametrize("stages", list(STAGES))
def test_robust_registrar_matches_jax(weights, stages, accurate):
    kw = dict(SMALL, egnn_accurate=accurate, **STAGES[stages])
    params = weights[accurate]
    ref = jserving.Registrar(params, jengine.robust_eval_config(**kw))
    got = tserving.Registrar(params_from_jax(params), tengine.robust_eval_config(**kw),
                             device="cpu")
    pb = _pairs()
    args = (pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat)
    tol = (1e-4, 1e-4, 1e-3, 1e-4) if accurate else (2e-2, 2e-2, None, 2e-2)
    _compare(ref.register(*args), got.register(*args), *tol)
    if accurate:    # and an unbatched request
        one = (pb.src_pts[0], pb.src_feat[0], pb.tgt_pts[0], pb.tgt_feat[0])
        _compare(ref.register(*one), got.register(*one), *tol)


def test_constructor_overrides_match_jax(weights):
    """The four constructor knobs override the config on both sides: a
    plain fast config plus refine_iters, spectral_topm and icp_iters given
    to the constructor equals robust_eval_config's stages."""
    kw = dict(SMALL, egnn_accurate=True, fusion_weighting="sharp")
    over = dict(refine_iters=3, refine_kernel="cauchy", spectral_topm=128, icp_iters=5)
    params = weights[True]
    ref = jserving.Registrar(params, jengine.fast_tpu_config(**kw), **over)
    got = tserving.Registrar(params_from_jax(params), tengine.fast_tpu_config(**kw),
                             device="cpu", **over)
    st = got.stages
    assert (st.refine_iters, st.refine_kernel, st.spectral_topm, st.icp_iters) == (
        3, "cauchy", 128, 5) and got.cfg.refine_iters == 0
    pb = _pairs()
    args = (pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat)
    _compare(ref.register(*args), got.register(*args), 1e-4, 1e-4, 1e-3, 1e-4)


def test_a_pyramid_that_does_not_end_at_the_raw_clouds_is_refused(weights):
    cfg = tengine.robust_eval_config(**SMALL, icp_iters=5, icp_voxels=(0.3, 0.1))
    with pytest.raises(ValueError, match="must end at 0.0"):
        tserving.Registrar(params_from_jax(weights[True]), cfg, device="cpu")
    # without ICP the pyramid is not used, so not checked (as in JAX)
    tserving.Registrar(params_from_jax(weights[True]),
                       tengine.robust_eval_config(**SMALL, icp_voxels=(0.3, 0.1)), device="cpu")


@pytest.mark.parametrize("stages", ["spectral+irls", "icp", "icp-pyramid"])
def test_eval_step_matches_jax_under_the_robust_configs(weights, stages):
    """make_eval_step with the robust stages (its ICP takes no prior
    weights, unlike the Registrar's), the port against JAX."""
    kw = dict(SMALL, egnn_accurate=True, **STAGES[stages])
    params = weights[True]
    jcfg = jengine.robust_eval_config(**kw)
    jmodel = jengine.build_model(jcfg, head_mode="eval_fusion")
    pb = _pairs()
    jbatch = jengine.batch_to_device((pb.corr, pb.labels, pb.src_pts, pb.tgt_pts,
                                      pb.src_feat, pb.tgt_feat, pb.gt_pose))
    ref = jax.tree_util.tree_map(np.asarray,
                                 jengine.make_eval_step(jmodel, jcfg)(params, jbatch))
    tcfg = tengine.robust_eval_config(**kw)
    model = tengine.build_model(tcfg, head_mode="eval_fusion", device="cpu")
    model.load_state_dict(params_from_jax(params))
    tbatch = tengine.batch_to_device((pb.corr, pb.labels, pb.src_pts, pb.tgt_pts,
                                      pb.src_feat, pb.tgt_feat, pb.gt_pose), "cpu")
    got = {k: v.numpy() for k, v in tengine.make_eval_step(model, tcfg)(tbatch).items()}
    np.testing.assert_allclose(got["trans_err_cm"], ref["trans_err_cm"], atol=1e-3)
    np.testing.assert_allclose(got["rot_err_deg"], ref["rot_err_deg"], atol=0.05)
    np.testing.assert_array_equal(got["recall"], ref["recall"])
    np.testing.assert_array_equal(got["precision"], ref["precision"])
    summary = tengine.evaluate(model, tcfg, [tbatch])
    assert np.isfinite(summary["avg_rotation_error_deg"])


def test_robust_stages_run_their_matmuls_in_full_float32(weights, monkeypatch):
    """With TF32 allowed by the caller, every matrix product of the robust
    stages and of the covariance still runs at 'highest' float32 precision
    (on the card TF32 would keep ~3 digits), and the caller's setting comes
    back afterwards."""
    from torch.overrides import TorchFunctionMode

    matmuls = {torch.matmul, torch.mm, torch.bmm, torch.einsum, torch.tensordot,
               torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.mm,
               torch.Tensor.bmm, torch.nn.functional.linear}
    seen, calls = [], []

    class Spy(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in matmuls:
                seen.append(torch.get_float32_matmul_precision())
            return func(*args, **(kwargs or {}))

    def watch(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls.append(name)
            with Spy():
                return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    for name in ("spectral_match_weights", "kabsch_irls", "icp_refine_multiscale"):
        watch(tengine, name)
    watch(tserving, "pose_covariance")
    reg = tserving.Registrar(params_from_jax(weights[True]),
                             tengine.robust_eval_config(**SMALL, egnn_accurate=True,
                                                        icp_iters=3, icp_voxels=(0.3, 0.0)),
                             device="cpu")
    pb = _pairs()
    prev = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        reg.register(pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat)
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(prev)
    assert calls == ["spectral_match_weights", "kabsch_irls", "icp_refine_multiscale",
                     "pose_covariance"]
    assert seen and set(seen) == {"highest"}, set(seen)
    assert after == "high"
