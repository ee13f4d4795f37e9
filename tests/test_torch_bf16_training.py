"""bf16 parameters with stochastic rounding (`utils/bf16_training.py` and the
engine's `bf16_params`), port against the JAX package on the CPU.

Tolerances, and the worst errors measured on this machine:
- SR lands on one of the two neighbouring bf16 values, and rounds up with
  the residual's probability within 4 sigma over 20 000 draws a value
  (measured at most 1.7 sigma);
- the masters after 5 Adam steps on one numpy gradient sequence, against
  the JAX `bf16_sr_optimizer`'s: 1e-6 relative plus 3e-5 lr a step
  (optax computes Adam's bias correction 1 - 0.999^t in fp32, 4.7e-5 off
  at t = 1, torch in float64, so each update differs by up to 2.4e-5 of
  lr; measured 2.4e-7 at a master of 2.9, one fp32 ulp, and 2.8e-8 after
  5 steps on masters of 4e-3); the masters do not depend on the SR draws,
  which the two packages draw from different generators;
- live within one bf16 ulp of its master after every step (the port
  writes SR(master)); the JAX package's live values within two (its delta
  re-rounding keeps them within one ulp of SR(master); measured 1.99);
- the initial live parameters equal the JAX `init_state` cast bit for bit;
- the first bf16 train step's loss breakdown within 1e-5 relative of the
  JAX step's (measured 1.5e-7); the masters after it as the fp32 train
  test holds parameters after Adam: within 1e-6 where the first gradient
  exceeds 1e-3 of its tensor's max, within 2 lr everywhere (measured
  7.4e-7 and 1.0e-4 = 1 lr: Adam's first step is lr g / (|g| + 1e-8), so
  a gradient near 1e-8 or near 0 moves with the summation order);
- a micro-step of gradient accumulation and a checkpoint round trip:
  exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_util import jax_model_params, jax_train_batch, pair_batches, port_train_batch

from se3_equi_graph_registration_tpu.train import engine as jengine
from se3_equi_graph_registration_tpu.train import losses as jlosses
from se3_equi_graph_registration_tpu.utils import bf16_training as jbf16
from se3_equi_graph_registration_tpu_torch.train import engine as tengine
from se3_equi_graph_registration_tpu_torch.train.checkpoints import (TrainCheckpointer,
                                                                      params_from_jax)
from se3_equi_graph_registration_tpu_torch.utils.bf16_training import (
    Bf16SROptimizer, stochastic_round_to_bf16, tree_stochastic_round)

SMALL = dict(num_nodes=256, k=8, in_node_nf=16, hidden_nf=16, n_layers=2, num_heads=2,
             top_k=32)


def _ulp(v: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing at each value: 2^(exponent - 7)."""
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32),
                       torch.frexp(v.float()).exponent - 8)


@pytest.mark.parametrize("frac", [0.1, 0.25, 0.5, 0.9])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_sr_rounds_up_with_the_residual_probability(frac, sign):
    lo = 1.5                                   # bf16-exact; its ulp is 2^-7
    x = torch.full((20000,), sign * (lo + frac * 2 ** -7), dtype=torch.float32)
    out = stochastic_round_to_bf16(x, torch.Generator().manual_seed(0)).float()
    hi = torch.tensor(sign * (lo + 2 ** -7))
    assert bool(torch.all((out == sign * lo) | (out == hi)))
    p_up = float((out == hi).double().mean())
    sigma = (frac * (1 - frac) / x.numel()) ** 0.5
    assert abs(p_up - frac) <= 4 * sigma, (p_up, frac, sigma)


def test_sr_passes_exact_and_nonfinite_values_and_skips_integers():
    exact = torch.tensor([0.0, 1.0, -2.0, 0.5, 2.0 ** 120, -1.5], dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    for _ in range(8):
        torch.testing.assert_close(stochastic_round_to_bf16(exact, gen).float(), exact,
                                   rtol=0, atol=0)
    weird = stochastic_round_to_bf16(torch.tensor([np.inf, -np.inf, np.nan]), gen).float()
    assert weird[0] == np.inf and weird[1] == -np.inf and bool(torch.isnan(weird[2]))
    tree = {"w": torch.full((4,), 1.0 + 2 ** -9), "n": torch.arange(4),
            "list": [torch.ones(2, dtype=torch.float64)], "tag": "x"}
    out = tree_stochastic_round(tree, gen)
    assert out["w"].dtype == out["list"][0].dtype == torch.bfloat16
    assert out["n"] is tree["n"] and out["tag"] == "x"


def test_updates_below_half_an_ulp_still_move_the_master():
    """SGD at lr 1 with a gradient of 2^-12 (the ulp at 1.0 is 2^-7): the
    master integrates every step exactly, the live values follow in
    expectation, where round to nearest would freeze them."""
    w = torch.nn.Parameter(torch.ones(512))
    sr = Bf16SROptimizer([w], lambda ps: torch.optim.SGD(ps, lr=1.0),
                         torch.Generator().manual_seed(0))
    assert w.dtype == torch.bfloat16
    for _ in range(20):
        w.grad = torch.full((512,), 2 ** -12, dtype=torch.bfloat16)
        sr.step()
        sr.zero_grad()
    np.testing.assert_allclose(sr.master[0].numpy(), 1.0 - 20 * 2 ** -12, rtol=1e-6)
    drift = 1.0 - float(w.detach().float().mean())
    np.testing.assert_allclose(drift, 20 * 2 ** -12, rtol=0.35)
    assert float(torch.tensor(1.0 - 2 ** -12).to(torch.bfloat16)) == 1.0


def test_masters_match_jax_across_adam_steps_and_live_stays_within_an_ulp():
    rng = np.random.default_rng(0)
    init = {"a": rng.standard_normal((64, 16)).astype(np.float32),
            "b": (rng.standard_normal(16) * 1e-3).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-6, 0)).astype(np.float32)
              for k, v in init.items()} for _ in range(5)]
    jopt = jbf16.bf16_sr_optimizer(optax.adam(1e-3), seed=0)
    jstate = jopt.init({k: jnp.asarray(v) for k, v in init.items()})
    jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in init.items()}
    live = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    sr = Bf16SROptimizer(live.values(), lambda ps: torch.optim.Adam(ps, lr=1e-3, eps=1e-8))
    worst = [0.0]
    for i, g in enumerate(grads):
        # the live gradients are bf16 in both packages
        gb = {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}
        upd, jstate = jopt.update(gb, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in live.items():
            p.grad = torch.from_numpy(np.asarray(gb[k], np.float32)).to(torch.bfloat16)
        sr.step()
        sr.zero_grad()
        for (k, p), m in zip(live.items(), sr.master):
            jm = np.array(jstate.master[k])
            # optax's bias correction 1 - 0.999^t is fp32 (4.7e-5 off at t = 1),
            # torch's float64: each update differs by up to ~2.4e-5 of lr
            np.testing.assert_allclose(m.numpy(), jm, rtol=1e-6, atol=3e-5 * 1e-3 * (i + 1),
                                       err_msg=k)
            assert bool(torch.all((p.float() - m).abs() <= _ulp(m))), k
            # JAX's live values: within one ulp of SR(master) by its delta
            # re-rounding, so within two of the master
            jl = torch.from_numpy(np.array(jparams[k], np.float32))
            jm = torch.from_numpy(jm)
            worst[0] = max(worst[0], float(((jl - jm).abs() / _ulp(jm)).max()))
            assert bool(torch.all((jl - jm).abs() <= 2 * _ulp(jm))), k
    assert worst[0] > 1.0          # JAX's contract is the looser one


def test_kernel_layout_of_bf16_parameters_folds_in_fp32():
    """`kernel_params` of a bf16 EGNN equals that of its fp32 upcast bit for
    bit (every fold in fp32, as the JAX wrapper's `params_from_tree(dtype=
    float32)` folds), so do the kernels' buffers, and the gradients of
    `egnn_forward` reach the bf16 leaves in bf16."""
    import copy

    from se3_equi_graph_registration_tpu_torch.ops.kernels.egcl import (egnn_forward,
                                                                          kernel_params)
    cfg = tengine.EngineConfig(**SMALL)
    egnn = tengine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu").model.egnn
    egnn.to(torch.bfloat16)
    upcast = copy.deepcopy(egnn).float()
    with torch.no_grad():
        bf, ref = kernel_params(egnn), kernel_params(upcast)
    for a, b in zip(bf.layers, ref.layers):
        for x, y in zip(a[:-1], b[:-1]):
            assert x.dtype == torch.float32 and torch.equal(x, y)
    for a, b in zip(bf.packed, ref.packed):
        assert all(x is None and y is None or torch.equal(x, y) for x, y in zip(a, b))
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((1, 64, 16)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 64, 3)).astype(np.float32))
    d2 = ((x[0, :, None] - x[0, None]) ** 2).sum(-1)
    nbr = torch.argsort(d2, dim=-1)[None, :, :8].to(torch.int32)
    out, _ = egnn_forward(kernel_params(egnn), h, x, nbr)
    out.sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.bfloat16 for p in egnn.parameters())


@pytest.fixture(scope="module")
def jax_first_step():
    """The JAX engine's bf16 state and first train step at SMALL, with its
    fp32 init (the same key)."""
    jcfg = jengine.EngineConfig(**SMALL, bf16_params=True)
    jmodel, params = jax_model_params(jcfg)
    (pb,) = pair_batches(2)
    batch = jax_train_batch(pb)
    opt = jengine.build_optimizer(jcfg)
    state = jengine.init_state(jmodel, opt, jcfg, jax.random.PRNGKey(0), batch)
    live0 = jax.tree_util.tree_map(np.asarray, state.params)
    state, m = jengine.make_train_step(jmodel, opt, jcfg)(state, batch)
    # the batch an argument: closed over, its k-NN sorts would be
    # constant-folded at compile time (~20 s each)
    g = jax.jit(jax.grad(lambda p, b: jlosses.total_loss(
        jengine._apply_with_graphs(jmodel, jcfg, p, b), b["gt_pose"], b["labels"],
        jcfg.loss_weights).total))(jax.tree_util.tree_map(jnp.asarray, live0), batch)
    return dict(params=params, live0=live0, metrics=jax.tree_util.tree_map(np.asarray, m),
                master=jax.tree_util.tree_map(np.asarray, state.opt_state.master),
                grads=params_from_jax(jax.tree_util.tree_map(np.asarray, g)), pb=pb)


def _port_state(params, **kw):
    cfg = tengine.EngineConfig(**SMALL, bf16_params=True, **kw)
    model = tengine.build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return cfg, tengine.TrainState(model, tengine.build_optimizer(model, cfg))


def test_first_bf16_train_step_matches_jax(jax_first_step):
    ref = jax_first_step
    cfg, state = _port_state(ref["params"])
    want0 = params_from_jax(ref["live0"])
    for name, p in state.model.named_parameters():      # the init cast, bit for bit
        assert p.dtype == want0[name].dtype == torch.bfloat16 and torch.equal(p, want0[name]), name
    assert all(m.dtype == torch.float32 for m in state.optimizer.sr.master)
    step = tengine.make_train_step(state.model, state.optimizer, cfg)
    state, m = step(state, port_train_batch(ref["pb"]))
    for name in jlosses.LossBreakdown._fields:
        want = float(ref["metrics"][name])
        assert abs(float(m[name]) - want) <= 1e-5 * max(abs(want), 1e-6), name
    master = params_from_jax(ref["master"])
    for (name, p), got in zip(state.model.named_parameters(), state.optimizer.sr.master):
        want, g0 = master[name].numpy(), ref["grads"][name].float().abs().numpy()
        big = g0 > 1e-3 * g0.max()
        np.testing.assert_allclose(got.numpy()[big], want[big], rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * cfg.lr, err_msg=name)
        assert p.dtype == torch.bfloat16 and bool(torch.all((p.float() - got).abs() <= _ulp(got)))


def test_accumulation_micro_step_leaves_live_and_master_untouched(jax_first_step):
    cfg, state = _port_state(jax_first_step["params"], grad_accum_steps=2)
    step = tengine.make_train_step(state.model, state.optimizer, cfg)
    sr = state.optimizer.sr
    live = [p.detach().clone() for p in state.model.parameters()]
    master = [m.clone() for m in sr.master]
    batches = [port_train_batch(pb) for pb in pair_batches(3, 2)]
    state, _ = step(state, batches[0])
    assert all(torch.equal(a, p) for a, p in zip(live, state.model.parameters()))
    assert all(torch.equal(a, m) for a, m in zip(master, sr.master))
    assert all(p.grad is None for p in state.model.parameters())
    assert any(m.grad is not None for m in sr.master)
    state, _ = step(state, batches[1])
    assert all(not torch.equal(a, m) for a, m in zip(master, sr.master))
    assert all(m.grad is None for m in sr.master)


def test_checkpoint_round_trip_continues_bit_for_bit(jax_first_step, tmp_path):
    batches = [port_train_batch(pb) for pb in pair_batches(4, 2)]

    def run(state, cfg, n):
        step = tengine.make_train_step(state.model, state.optimizer, cfg)
        losses = []
        for i in range(n):
            state, m = step(state, batches[i % 2])
            losses.append(float(m["total"]))
        return state, losses

    cfg, state = _port_state(jax_first_step["params"])
    state, _ = run(state, cfg, 2)
    ck = TrainCheckpointer(str(tmp_path))
    assert ck.save(state.step, state)
    state, want = run(state, cfg, 2)

    template = tengine.init_state(cfg, torch.Generator().manual_seed(9), device="cpu")
    restored, step_no = ck.restore_latest(template)
    assert step_no == 2 and restored.step == 2
    restored, got = run(restored, cfg, 2)
    assert got == want
    for a, b in zip(restored.model.parameters(), state.model.parameters()):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    for a, b in zip(restored.optimizer.sr.master, state.optimizer.sr.master):
        assert torch.equal(a, b)
