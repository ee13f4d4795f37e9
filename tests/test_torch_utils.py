"""The engine's `remat` and `fit(profile_dir=)`, and the port's utilities
(`utils/timer.py`, `utils/logging.py`, `utils/debugging.py`) against the
JAX package's, on the CPU at a small size (N=256, k=8, C=16, 2 layers, 2
heads, top_k=32).

Tolerances: `remat` recomputes the same fp32 operations in the same order
on the CPU, so the loss and every parameter's gradient are held
`torch.equal`; the utilities' outputs are exact apart from wall-clock
fields.
"""
import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch_port_util import pair_batches, port_train_batch

from se3_equi_graph_registration_tpu.utils import logging as jlogging
from se3_equi_graph_registration_tpu.utils import timer as jtimer
from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl
from se3_equi_graph_registration_tpu_torch.train import engine
from se3_equi_graph_registration_tpu_torch.train.checkpoints import TrainCheckpointer
from se3_equi_graph_registration_tpu_torch.utils import debugging, timer
from se3_equi_graph_registration_tpu_torch.utils import logging as tlogging

SMALL = dict(num_nodes=256, k=8, in_node_nf=16, hidden_nf=16, n_layers=2, num_heads=2,
             top_k=32)


def _grads(cfg, batch, monkeypatch):
    """(loss, {parameter: gradient}, EGCL forward calls) of one backward."""
    calls = []
    real = egcl.egcl_layer

    def spy(*a, **k):
        calls.append(k.get("return_aggm", False))
        return real(*a, **k)

    monkeypatch.setattr(egcl, "egcl_layer", spy)
    state = engine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    lb = engine.train_loss(state.model, cfg, batch)
    lb.total.backward()
    monkeypatch.setattr(egcl, "egcl_layer", real)
    return lb.total.detach(), {n: p.grad for n, p in state.model.named_parameters()}, calls


@pytest.mark.parametrize("knobs", [dict(), dict(knn_method="morton", egnn_window=128,
                                               egnn_accurate=False, knn_packed=True)],
                         ids=["exact-accurate", "morton-fast"])
def test_remat_recomputes_the_egnn_and_changes_nothing(knobs, monkeypatch):
    """remat=True: the backward runs every EGCL forward again (2·L more
    calls, each with agg_m, through EGCLFunction), and the loss and the
    gradient of every parameter, the folded weights' included, are those
    of remat=False exactly."""
    cfg = engine.EngineConfig(**SMALL, **knobs)
    batch = port_train_batch(pair_batches(1, b=2, n=256, c=16)[0])
    loss, grads, calls = _grads(cfg, batch, monkeypatch)
    rloss, rgrads, rcalls = _grads(dataclasses.replace(cfg, remat=True), batch, monkeypatch)
    two_l = 2 * cfg.n_layers
    assert calls == [True] * two_l and rcalls == [True] * (2 * two_l)
    assert torch.equal(loss, rloss)
    assert set(grads) == set(rgrads)
    for name, g in grads.items():
        assert g is not None and torch.equal(g, rgrads[name]), name
    # inference keeps no graph, so remat changes nothing there
    model = engine.build_model(cfg, device="cpu")
    a = engine._apply_with_graphs(model, cfg, batch)
    b = engine._apply_with_graphs(model, dataclasses.replace(cfg, remat=True), batch)
    assert torch.equal(a.R, b.R) and torch.equal(a.t, b.t)


def test_fit_profile_dir_writes_a_trace(tmp_path):
    cfg = engine.EngineConfig(**SMALL)
    state = engine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    pb = pair_batches(1, b=2, n=256, c=16)[0]
    tuples = [(pb.corr, pb.labels, pb.src_pts, pb.tgt_pts, pb.src_feat, pb.tgt_feat, pb.gt_pose)]
    prof = str(tmp_path / "prof")
    state = engine.fit(state.model, state.optimizer, cfg, state, lambda: tuples, epochs=2,
                       profile_dir=prof)
    assert state.step == 2 and os.listdir(prof) == ["trace.json"]
    events = json.load(open(os.path.join(prof, "trace.json")))["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("addmm" in n or "matmul" in n or "mm" in n for n in names), sorted(names)[:20]


def test_timer_and_average_meter_match_jax(monkeypatch):
    ticks = iter([1.0, 1.5, 2.0, 2.25])
    monkeypatch.setattr(timer.time, "perf_counter", lambda: next(ticks))
    t = timer.Timer()
    t.tic()
    assert t.toc() == 0.5
    t.tic()
    assert t.toc(average=False) == 0.25 and t.avg == 0.375 and t.calls == 2
    got, want = timer.AverageMeter(), jtimer.AverageMeter()
    for v, n in ((1.0, 2), (4.0, 1), (0.5, 3)):
        got.update(v, n)
        want.update(v, n)
    assert vars(got) == vars(want)


def test_device_timer_on_the_cpu_reports_wall_time():
    lines = []
    with timer.device_timer("step", device="cpu", sink=lines.append):
        torch.ones(8).sum()
    assert len(lines) == 1 and lines[0].startswith("step: ") and lines[0].endswith(" ms")


def test_metrics_logger_writes_what_the_jax_logger_writes(tmp_path):
    outs = {}
    for name, mod in (("port", tlogging), ("jax", jlogging)):
        log = mod.MetricsLogger(str(tmp_path / name), stdout=False, tensorboard=False)
        log.log(1, {"loss": 0.5, "acc": np.float32(0.25)})
        log.log(2, {"loss": 0.25, "acc": 0.5}, prefix="val")
        log.close()
        rows = [json.loads(line) for line in open(tmp_path / name / "metrics.jsonl")]
        table = list(csv.reader(open(tmp_path / name / "metrics.csv")))
        outs[name] = ([{k: v for k, v in r.items() if k != "wall_s"} for r in rows],
                      [row[:1] + row[2:] for row in table])
    assert outs["port"] == outs["jax"]
    assert outs["port"][0][1] == {"step": 2, "val/loss": 0.25, "val/acc": 0.5}


def test_nonfinite_checks_over_a_state_dict_and_optimizer_state():
    cfg = engine.EngineConfig(**SMALL)
    state = engine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = engine.make_train_step(state.model, state.optimizer, cfg)
    state, _ = step(state, port_train_batch(pair_batches(1, b=2, n=256, c=16)[0]))
    sd, opt = state.model.state_dict(), state.optimizer.adam.state_dict()
    assert bool(debugging.tree_all_finite(sd)) and bool(debugging.tree_all_finite(opt))
    assert debugging.find_nonfinite(sd) == [] and debugging.find_nonfinite({"n": 3}) == []
    opt["state"][2]["exp_avg"].view(-1)[0] = float("nan")
    sd["egnn.gcl_1.node_mlp_0.bias"][0] = float("inf")
    assert not bool(debugging.tree_all_finite([sd, opt]))
    assert debugging.find_nonfinite([sd, opt]) == ["[0]['egnn.gcl_1.node_mlp_0.bias']",
                                                   "[1]['state'][2]['exp_avg']"]
    try:
        debugging.nan_checks(True)
        assert torch.is_anomaly_enabled()
    finally:
        debugging.nan_checks(False)
    assert not torch.is_anomaly_enabled()


def test_guard_fit_saves_an_emergency_checkpoint(tmp_path):
    cfg = engine.EngineConfig(**SMALL)
    state = engine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    state.step = 5
    ckpt = TrainCheckpointer(str(tmp_path / "ck"))

    def fit():
        raise KeyboardInterrupt      # a preemption: not an Exception, still saved

    with pytest.raises(KeyboardInterrupt):
        debugging.guard_fit(fit, ckpt, lambda: state)
    assert ckpt.steps() == [5]
    saved = torch.load(os.path.join(ckpt.directory, "step_5.pt"), weights_only=True)
    assert saved["metrics"] == {"emergency": 1.0}
    template = engine.init_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    restored, step = ckpt.restore_latest(template)
    assert step == 5 and all(torch.equal(a, b) for a, b in zip(
        restored.model.state_dict().values(), state.model.state_dict().values()))
    assert debugging.guard_fit(lambda: 7, ckpt, lambda: state) == 7
