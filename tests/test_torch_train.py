"""The training slice as a whole: the port's train step against the JAX
train step on the same numpy batches and weights, at a small
fast_tpu_config (N=256, k=16, C_in=C=16, 2 layers, 2 heads, top_k=32,
tile 128, window 128), the shape tests/test_pallas_kernels.py trains on.

The JAX side runs as its own tests run it on the CPU: the morton path with
the Pallas kernels in interpret mode (forward, and the hand-written backward
through the custom VJP). Premise made explicit: the JAX CPU path builds the
exact window graph, the port's plain path the packed one; the first test
asserts they are equal on these batches.

Tolerances:
- accurate (fp32 on both sides): the loss breakdown to 1e-5 relative; each
  parameter's gradient at cosine ≥ 0.9999 and relative L2 ≤ 1e-3 (only
  summation orders differ; measured: loss 2.5e-7, worst cosine 1 − 1.3e-12,
  worst relative L2 1.9e-6, for both solvers).
- post-Adam parameters after 3 steps with lr_step=2 (the schedule halves
  the rate before step 3): Adam's first update is ±lr·g/(|g|+ε), so an
  element whose gradient sits at the noise floor may flip sign. Elements
  whose first gradient exceeds 1e-3 of the tensor's max agree to 1e-6;
  every element agrees to 2·lr per step.
- gradient accumulation (one Adam step from 2 micro-batches, against
  optax.MultiSteps): every element within 2·lr, and each tensor's mean
  |Δ| within 0.05·lr (measured: 3 of 5217 elements beyond 1e-6, the
  sign flips above; worst mean 7.8e-7 = 0.008·lr).

Fast mode, `fit` and `evaluate` are in tests/test_torch_train_loop.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_util import (cosine, jax_grads, jax_model_params, jax_train_batch,
                             pair_batches, port_grads, port_model, port_train_batch)

from se3_equi_graph_registration_tpu.ops import morton as jm
from se3_equi_graph_registration_tpu.train import engine as jengine
from se3_equi_graph_registration_tpu.train import losses as jlosses
from se3_equi_graph_registration_tpu_torch.ops import morton as tm
from se3_equi_graph_registration_tpu_torch.ops.kernels.knn import knn_window
from se3_equi_graph_registration_tpu_torch.train import engine as tengine
from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

SMALL = dict(num_nodes=256, k=16, in_node_nf=16, hidden_nf=16, n_layers=2,
             num_heads=2, top_k=32, egnn_window=128)


def test_graph_premise_jax_exact_and_port_packed_window_graphs_agree():
    for pb in pair_batches(1, 3) + pair_batches(8, 2):
        for pts in (pb.src_pts, pb.tgt_pts):
            xs = tm.sort_by_curve(torch.zeros(2, 256, 1), torch.from_numpy(pts))[1]
            jxs = jm.sort_by_curve(jnp.zeros((2, 256, 1)), jnp.asarray(pts))[1]
            np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
            ref = np.asarray(jax.vmap(lambda p: jm.knn_graph_window(p, 16, tile=128,
                                                                    window=128))(jxs))
            got = knn_window(xs.contiguous(), 16, tile=128, window=128, packed=True).numpy()
            np.testing.assert_array_equal(np.sort(got, -1), np.sort(ref, -1))


@pytest.mark.parametrize("solver", ["svd", "quaternion"])
def test_accurate_train_step_matches_jax(solver):
    kw = dict(SMALL, egnn_accurate=True, kabsch_solver=solver, lr_step=2)
    jcfg = jengine.fast_tpu_config(**kw)
    jmodel, params = jax_model_params(jcfg)
    tcfg, model = port_model(kw, params)
    pbs = pair_batches(1, 3)

    jlb, jg = jax_grads(jmodel, jcfg, params, jax_train_batch(pbs[0]))
    tlb, tg = port_grads(model, tcfg, port_train_batch(pbs[0]))
    for name in jlosses.LossBreakdown._fields:
        ref = float(getattr(jlb, name))
        assert abs(float(getattr(tlb, name).detach()) - ref) <= 1e-5 * max(abs(ref), 1e-6), name
    assert set(tg) == set(jg)
    for name, ref in jg.items():
        assert cosine(tg[name], ref) >= 0.9999, (name, cosine(tg[name], ref))
        assert np.linalg.norm(tg[name] - ref) <= 1e-3 * np.linalg.norm(ref), name

    # three Adam steps across the schedule boundary, on both sides
    opt = jengine.build_optimizer(jcfg)
    jstate = jengine.TrainState(params=params, opt_state=opt.init(params),
                                step=jnp.zeros((), jnp.int32))
    jstep = jengine.make_train_step(jmodel, opt, jcfg)
    model.zero_grad(set_to_none=True)
    state = tengine.TrainState(model, tengine.build_optimizer(model, tcfg))
    step = tengine.make_train_step(model, state.optimizer, tcfg)
    for pb in pbs:
        jstate, jm_ = jstep(jstate, jax_train_batch(pb))
        state, tm_ = step(state, port_train_batch(pb))
        assert abs(float(tm_["total"]) - float(jm_["total"])) <= 1e-5 * abs(float(jm_["total"]))
    assert state.step == 3
    # steps 0, 1 ran at lr, step 2 at lr/2; step 3 would too
    assert state.optimizer.adam.param_groups[0]["lr"] == pytest.approx(tcfg.lr / 2)
    jp = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    for name, p in model.named_parameters():
        got, ref, g0 = p.detach().numpy(), jp[name].numpy(), np.abs(jg[name])
        big = g0 > 1e-3 * g0.max()
        np.testing.assert_allclose(got[big], ref[big], rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2 * tcfg.lr * 3, err_msg=name)


def test_grad_accumulation_matches_jax_multisteps():
    kw = dict(SMALL, egnn_accurate=True, grad_accum_steps=2)
    jcfg = jengine.fast_tpu_config(**kw)
    jmodel, params = jax_model_params(jcfg)
    tcfg, model = port_model(kw, params)
    opt = jengine.build_optimizer(jcfg)
    assert isinstance(opt, optax.MultiSteps)
    jstate = jengine.TrainState(params=params, opt_state=opt.init(params),
                                step=jnp.zeros((), jnp.int32))
    jstep = jengine.make_train_step(jmodel, opt, jcfg)
    state = tengine.TrainState(model, tengine.build_optimizer(model, tcfg))
    step = tengine.make_train_step(model, state.optimizer, tcfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for i, pb in enumerate(pair_batches(8, 2)):
        jstate, _ = jstep(jstate, jax_train_batch(pb))
        state, _ = step(state, port_train_batch(pb))
        moved = any(not torch.equal(before[k], v) for k, v in model.state_dict().items())
        assert moved == (i == 1)      # the optimizer steps once per 2 micro-batches
    jp = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[name].numpy(), rtol=0,
                                   atol=2 * tcfg.lr, err_msg=name)
        assert np.mean(np.abs(p.detach().numpy() - jp[name].numpy())) <= 0.05 * tcfg.lr, name
