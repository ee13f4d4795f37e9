"""The port's named host stages (`utils/timer.span`) and the serving front's
byte counter, on the CPU.

- off: with no profiler recording, `span()` is one shared null context and
  never builds a `record_function`;
- on: a `Registrar.register` call and a train step, each under
  `torch.profiler` (CPU activity), leave their stage spans in the trace as
  `user_annotation` events, in order, without overlap, with the forward's
  spans inside them;
- `serving.counters` counts the calls and the bytes each copies to the
  device: B·N·(3 + C + 3 + C + 1)·4 for float32 points, descriptors and
  labels.
"""
import json

import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu_torch import serving
from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
from se3_equi_graph_registration_tpu_torch.train import engine
from se3_equi_graph_registration_tpu_torch.utils import timer

N, C = 256, 16
SMALL = dict(num_nodes=N, k=8, in_node_nf=C, hidden_nf=C, n_layers=2, num_heads=2, top_k=32,
             egnn_window=256)
REGISTER_STAGES = ["register.sample", "register.copy_in", "register.forward",
                   "register.copy_out"]


def _annotations(prof, tmp_path) -> list:
    """(start, end, name) of the trace's `user_annotation` events, in time order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(out)


def _profile(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.fixture(scope="module")
def registrar():
    torch.manual_seed(0)
    cfg = engine.fast_tpu_config(**SMALL)
    model = engine.build_model(cfg, head_mode="eval_fusion", device="cpu")
    reg = serving.Registrar(model.state_dict(), cfg, head_mode="eval_fusion", device="cpu")
    pb = make_pair_batch(np.random.default_rng(3), batch=2, n=N + 40, feat_dim=C)
    return reg, (pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat)


def test_span_off_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first, second = timer.span("register.sample"), timer.span("train.step")
    assert first is second
    with first:
        pass


def test_span_on_is_a_user_annotation(tmp_path):
    def body():
        with timer.span("outer"):
            with timer.span("inner"):
                torch.ones(3).sum()

    spans = _annotations(_profile(body), tmp_path)
    by_name = {n: (a, b) for a, b, n in spans}
    assert set(by_name) == {"outer", "inner"}
    assert _inside(by_name["inner"], by_name["outer"])


def test_register_stages_in_order_covering_the_call(registrar, tmp_path):
    reg, req = registrar
    reg.register(*req, seed=1)           # warm: the first call pays for lazy imports

    def call():
        with torch.profiler.record_function("call"):
            reg.register(*req, seed=2)

    spans = _annotations(_profile(call), tmp_path)
    call_span = next(s for s in spans if s[2] == "call")
    stages = [s for s in spans if s[2].startswith("register.")]
    assert [s[2] for s in stages] == REGISTER_STAGES
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))        # no overlap
    assert all(_inside(s, call_span) for s in stages)
    covered = sum(b - a for a, b, _ in stages)
    assert covered >= 0.95 * (call_span[1] - call_span[0])
    forward = stages[2]
    children = [s for s in spans if s[2].startswith("forward.")]
    names = {s[2] for s in children}
    assert names == {"forward.curve_sort", "forward.knn", "forward.egnn", "forward.head",
                     "forward.robust", "forward.covariance"}
    assert all(_inside(s, forward) for s in children)
    # each cloud: sorted, its graph, its EGNN, unsorted
    assert sum(s[2] == "forward.knn" for s in children) == 2
    assert sum(s[2] == "forward.curve_sort" for s in children) == 4


def test_register_counts_calls_and_bytes_in(registrar):
    reg, req = registrar
    before = dict(serving.counters)
    reg.register(*req, seed=4)
    b = len(req[0])
    assert serving.counters["calls"] == before["calls"] + 1
    assert serving.counters["bytes_in"] == before["bytes_in"] + b * N * (7 + 2 * C) * 4


def test_register_clique_span_comes_first(registrar, tmp_path):
    reg, req = registrar
    one = tuple(a[:1, :64] for a in req)
    spans = _annotations(_profile(lambda: reg.register(*one, clique_prefilter=True)), tmp_path)
    stages = [s[2] for s in spans if s[2].startswith("register.")]
    assert stages == ["register.clique"] + REGISTER_STAGES


@pytest.fixture(scope="module")
def train_parts():
    torch.manual_seed(1)
    pb = make_pair_batch(np.random.default_rng(5), batch=2, n=N, feat_dim=C)
    batch = engine.batch_to_device((pb.corr, pb.labels, pb.src_pts, pb.tgt_pts, pb.src_feat,
                                    pb.tgt_feat, pb.gt_pose), "cpu")
    return batch


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_stages(train_parts, accum, tmp_path):
    cfg = engine.EngineConfig(**{k: v for k, v in SMALL.items() if k != "egnn_window"},
                              grad_accum_steps=accum)
    state = engine.init_state(cfg, torch.Generator().manual_seed(2), device="cpu")
    step = engine.make_train_step(state.model, state.optimizer, cfg)
    for i in range(accum):
        path = tmp_path / str(i)
        path.mkdir()
        holder = {}
        prof = _profile(lambda: holder.update(out=step(state, train_parts)))
        spans = _annotations(prof, path)
        stages = [s for s in spans if s[2].startswith("train.")]
        last = i == accum - 1            # the micro-step that steps Adam
        want = ["train.forward", "train.backward"] + (["train.optimizer"] if last else [])
        assert [s[2] for s in stages] == want
        assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))
        children = {s[2] for s in spans if s[2].startswith("forward.")
                    and _inside(s, stages[0])}
        assert children >= {"forward.knn", "forward.egnn", "forward.head", "forward.losses"}
        assert torch.isfinite(holder["out"][1]["total"])
