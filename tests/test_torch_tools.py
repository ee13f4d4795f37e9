"""The port's `tools/stats.py`, `tools/grad_budget.py` and
`tools/scenario_table.py` against the JAX package's `tools/stats.py`,
`tools/grad_budget.py` and `examples/scenario_table.py`, on the CPU.

- stats: the same dict as JAX's on one seeded dataset, exactly.
- grad_budget, the machinery (JAX's `tests/test_grad_budget.py` case, n=256,
  B=2, k=8, c=16): one row per parameter tensor, names unique, the twins'
  settings. JAX's CPU runs fp32 on both sides, so its case holds every
  cosine > 0.99. The port's plain fast EGCL rounds its operands to bf16 as
  the tile kernels do, and at seeded weights the saturated Kabsch softmax
  turns that into cosines far below 1 (ROADMAP Queue C item 3), so the
  port's > 0.99 case runs the fast side with that rounding off: what is left
  is the machinery and packed-key tie churn, as in JAX's case (measured
  worst cosine 0.9985).
- grad_budget, the accurate side: its per-tensor gradients against JAX's
  gradients of the same loss at the same weights (`params_from_jax`), on a
  batch seed whose graphs agree (`tests/torch_port_util.py`): cosine ≥
  0.9999 and relative L2 ≤ 1e-3 per tensor, as `tests/test_torch_train.py`
  holds the train step (only summation orders differ; measured worst
  cosine 1 − 5.3e-9, worst relative L2 1.1e-4, median 6.6e-6).
- scenario_table: `run_scenario` at 2 seeds, full overlap, 'spectral' and
  'ransac', against the JAX example's. The same successes; each seed's
  rotation and translation errors within 0.1 deg and 0.1 cm of JAX's (both
  sides land ~0.05-0.12 deg from the truth: with independently sampled
  clouds ICP does not settle in 10 steps, `tests/test_torch_registration.py`,
  and 'ransac' draws the port's triplets, not JAX's).
"""
import importlib.util
import os

import numpy as np
import pytest
from torch_port_util import jax_grads, jax_model_params, jax_train_batch, pair_batches, \
    port_train_batch

from se3_equi_graph_registration_tpu.data.synthetic import make_pair_batch
from se3_equi_graph_registration_tpu.tools import stats as jstats
from se3_equi_graph_registration_tpu.train import engine as jengine
from se3_equi_graph_registration_tpu_torch.tools import grad_budget
from se3_equi_graph_registration_tpu_torch.tools import scenario_table as tscen
from se3_equi_graph_registration_tpu_torch.tools import stats as tstats
from se3_equi_graph_registration_tpu_torch.train import engine as tengine
from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n=256, batch=2, k=8, c=16)


def test_stats_equal_jax_exactly(capsys):
    rng = np.random.default_rng(4)
    data = [tuple(a[0] for a in make_pair_batch(rng, batch=1, n=64, feat_dim=4,
                                                inlier_ratio=float(r)))
            for r in rng.uniform(0.05, 0.95, 12)]
    for max_pairs in (None, 7):
        got = tstats.inlier_ratio_stats(data, max_pairs=max_pairs)
        assert got == jstats.inlier_ratio_stats(data, max_pairs=max_pairs)
    tstats.print_stats(got)
    assert '"num_pairs": 7' in capsys.readouterr().out


def test_grad_table_cpu_machinery():
    rows, fast_cfg, acc_cfg = grad_budget.grad_table(
        **SMALL, seed=0, device="cpu", fast_overrides={"egnn_accurate": True})
    assert len(rows) > 10                       # one row per param tensor
    names = [r[0] for r in rows]
    assert len(set(names)) == len(names)
    assert any("gcl" in n for n in names)       # EGNN layer params present
    assert fast_cfg.knn_packed and not acc_cfg.knn_packed and acc_cfg.egnn_accurate
    worst_cos, worst_rel, _ = grad_budget.summary(rows)
    assert worst_cos > 0.99, rows[:3]
    assert np.isfinite(worst_rel)
    # the shipped twin, bf16 operands on the fast side (--same-graph runs in
    # the CLI case below): the table is finite and has the same rows
    fast_rows, fast_cfg, _ = grad_budget.grad_table(**SMALL, seed=0, device="cpu")
    assert not fast_cfg.egnn_accurate and sorted(r[0] for r in fast_rows) == sorted(names)
    assert all(np.isfinite(r[1]) and np.isfinite(r[2]) for r in fast_rows)


def test_grad_budget_cli_needs_weights(capsys):
    with pytest.raises(SystemExit):
        grad_budget.main(["--device", "cpu", "--n", "256"])
    rows = grad_budget.main(["--device", "cpu", "--n", "128", "--batch", "1",
                             "--random-init", "--same-graph"])
    out = capsys.readouterr()
    assert "worst cosine" in out.out and "does not measure the kernels" in out.err
    assert len(rows) > 10


def test_accurate_gradients_equal_jax():
    """The accurate twin's per-tensor gradients, port against JAX, at the
    same weights on a batch whose graphs agree (seed 1)."""
    kw = dict(num_nodes=SMALL["n"], k=SMALL["k"], in_node_nf=SMALL["c"], hidden_nf=32,
              top_k=128, egnn_accurate=True, knn_packed=False)
    jcfg = jengine.fast_tpu_config(**kw, onehot_h_permute=False)
    model, params = jax_model_params(jcfg)
    (pb,) = pair_batches(1, b=SMALL["batch"], n=SMALL["n"], c=SMALL["c"])
    _, want = jax_grads(model, jcfg, params, jax_train_batch(pb))
    got = grad_budget.gradients(params_from_jax(params), tengine.fast_tpu_config(**kw),
                                port_train_batch(pb))
    assert sorted(got) == sorted(want)
    rows = grad_budget.compare(got, {k: v.astype(np.float64) for k, v in want.items()})
    worst_cos, worst_rel, _ = grad_budget.summary(rows)
    assert worst_cos >= 0.9999 and worst_rel <= 1e-3, rows[:3]


@pytest.fixture(scope="module")
def jax_scenarios():
    spec = importlib.util.spec_from_file_location(
        "jax_scenario_table", os.path.join(ROOT, "examples", "scenario_table.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("coarse", ["spectral", "ransac"])
def test_run_scenario_matches_the_jax_example(jax_scenarios, coarse):
    label, x_range, _, knobs = tscen.SCENARIOS[0]
    assert tscen.SCENARIOS == jax_scenarios.SCENARIOS
    want = jax_scenarios.run_scenario(jax_scenarios.make_bumpy_surface(), coarse, x_range,
                                      2, knobs)
    got = tscen.run_scenario(tscen.make_bumpy_surface(), coarse, x_range, 2, knobs,
                             device="cpu")
    assert got[2] == want[2] == 2
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=0.1)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=0.1)
    line = tscen.cell_line(label, coarse, *got)
    assert line.startswith(f"{label:<24s} {coarse:<9s} 2/2 ok")
