"""Port vs JAX: the engine's eval step (whole-cloud exact k-NN graphs, the
train head) and its metrics, on one synthetic batch. The JAX side runs
each of its EGNN implementations; the port runs its one fused path (the
kernels' plain versions on the CPU) under either `egnn_impl` name.

Tolerance: both sides fp32. The graphs are exact on random continuous
inputs, so they agree as sets. The only differences are summation orders,
so poses agree to 1e-4. Angles are compared through the metrics: RTE to 1e-3
cm, RRE to 0.05°, since arccos amplifies fp32 noise near 0°. Recall and
precision must be equal.
"""
import jax
import numpy as np
import pytest
import torch
from torch_port_util import jax_model_params

from se3_equi_graph_registration_tpu.data.synthetic import make_pair_batch
from se3_equi_graph_registration_tpu.train import engine as jengine
from se3_equi_graph_registration_tpu_torch.train import engine as tengine
from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

SMALL = dict(num_nodes=256, k=8, in_node_nf=16, hidden_nf=16, n_layers=2,
             num_heads=2, top_k=32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_eval_step_matches_jax(impl):
    cfg_kw = dict(SMALL, egnn_impl=impl)
    jcfg = jengine.EngineConfig(**cfg_kw)
    jmodel, params = jax_model_params(jcfg)
    pb = make_pair_batch(np.random.default_rng(4), batch=2, n=256, feat_dim=16)
    jbatch = jengine.batch_to_device((pb.corr, pb.labels, pb.src_pts, pb.tgt_pts,
                                      pb.src_feat, pb.tgt_feat, pb.gt_pose))
    ref = jax.tree_util.tree_map(np.asarray, jengine.make_eval_step(jmodel, jcfg)(params, jbatch))

    tcfg = tengine.EngineConfig(**cfg_kw)
    model = tengine.build_model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    tbatch = {k: torch.from_numpy(np.array(getattr(pb, k))) for k in
              ("labels", "src_pts", "tgt_pts", "src_feat", "tgt_feat", "gt_pose")}
    got = {k: v.numpy() for k, v in tengine.make_eval_step(model, tcfg)(tbatch).items()}
    np.testing.assert_allclose(got["trans_err_cm"], ref["trans_err_cm"], atol=1e-3)
    np.testing.assert_allclose(got["rot_err_deg"], ref["rot_err_deg"], atol=0.05)
    np.testing.assert_array_equal(got["recall"], ref["recall"])
    np.testing.assert_array_equal(got["precision"], ref["precision"])


def test_batch_on_another_device_is_refused():
    model = tengine.build_model(tengine.EngineConfig(**SMALL), device="cpu")
    batch = {k: torch.zeros(1, 256, 3, device="meta") for k in
             ("src_pts", "tgt_pts", "src_feat", "tgt_feat", "labels")}
    with pytest.raises(ValueError, match="model on cpu"):
        tengine._apply_with_graphs(model, tengine.EngineConfig(**SMALL), batch)
