"""The program-span and program-counter readers on made-up traces, the idle
gaps' labels by the program's spans, and on the card one traced call whose
spans and kernels share a clock.

    python -m pytest benchmark/tests/test_bench_spans.py [-m card]
"""
import json
import os

import pytest

from benchmark import run, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EVAL = ("eval_sample_ms", "eval_forward_ms")
TRAIN = ("train_forward_ms", "train_backward_ms", "train_optimizer_ms")


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _serving_events():
    """Two calls of 500 us: sampling 200 (a numpy gap with no torch op), the
    copy in 50, the forward 150 (k-NN span 20 holding its kernel), the copy
    out 90."""
    out = [_ev("user_annotation", "window", 0.0, 1000.0)]
    for t0 in (0.0, 500.0):
        out += [_ev("user_annotation", "register", t0 + 5.0, 490.0),
                _ev("user_annotation", "register.sample", t0 + 5.0, 200.0),
                _ev("cpu_op", "aten::from_numpy", t0 + 195.0, 5.0),
                _ev("user_annotation", "register.copy_in", t0 + 205.0, 50.0),
                _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", t0 + 220.0, 30.0),
                _ev("user_annotation", "register.forward", t0 + 255.0, 150.0),
                _ev("user_annotation", "forward.knn", t0 + 300.0, 20.0),
                _ev("kernel", "knn_warp_kernel<2>", t0 + 310.0, 40.0),
                _ev("user_annotation", "register.copy_out", t0 + 405.0, 90.0)]
    return out


def _train_events(optimizer: bool = True):
    """Two steps of 500 us: forward 200, backward 150, Adam 100."""
    out = [_ev("user_annotation", "window", 0.0, 1000.0)]
    for t0 in (0.0, 500.0):
        out += [_ev("user_annotation", "step", t0 + 10.0, 480.0),
                _ev("user_annotation", "train.forward", t0 + 10.0, 200.0),
                _ev("user_annotation", "forward.egnn", t0 + 50.0, 100.0),
                _ev("kernel", "egcl_tile_f32_kernel<32>", t0 + 60.0, 100.0),
                _ev("user_annotation", "train.backward", t0 + 220.0, 150.0),
                _ev("kernel", "egcl_bwd_tile_f32_kernel<32>", t0 + 230.0, 100.0)]
        if optimizer:
            out.append(_ev("user_annotation", "train.optimizer", t0 + 380.0, 100.0))
    return out


def _reading(events, span):
    return trace.Reading(events, 2, None, 1e-3, (span, "copy_batch"))


def test_serving_readers_read_the_stage_spans_a_call():
    r = _reading(_serving_events(), "register")
    assert abs(run.reader("eval_sample_ms")(r) - 0.200) < 1e-12
    assert abs(run.reader("eval_forward_ms")(r) - 0.150) < 1e-12


def test_train_readers_read_the_stage_spans_a_step():
    r = _reading(_train_events(), "step")
    got = {m: run.reader(m)(r) for m in TRAIN}
    for m, want in zip(TRAIN, (0.200, 0.150, 0.100)):
        assert abs(got[m] - want) < 1e-12, (m, got)


def test_readers_are_silent_where_the_program_records_no_span():
    bench_only = [e for e in _serving_events() + _train_events()[1:]
                  if e["cat"] != "user_annotation" or e["name"] in ("window", "register", "step")]
    for span in ("register", "step"):
        r = _reading(bench_only, span)
        assert all(run.reader(m)(r) is None for m in EVAL + TRAIN)
    assert run.reader("train_optimizer_ms")(_reading(_train_events(False), "step")) is None


def test_a_bench_span_named_like_a_stage_is_not_read():
    """A span the benchmark opens itself is never the program's."""
    events = [_ev("user_annotation", "window", 0.0, 100.0),
              _ev("user_annotation", "train.forward", 0.0, 50.0)]
    r = trace.Reading(events, 1, None, 1e-3, ("train.forward",))
    assert run.reader("train_forward_ms")(r) is None


def test_idle_gaps_take_the_stage_span_as_their_label():
    r = _reading(_serving_events(), "register")
    gaps = dict(r.breakdown()["idle_gaps"])
    # [0, 220): mid 110 in register.sample, no torch op; [250, 310) and [750, 810):
    # register.forward; [350, 720): mid 535 in the second call's sampling;
    # [850, 1000): mid 925 in its copy out
    assert set(gaps) == {"register/register.sample", "register/register.forward",
                         "register/register.copy_out"}
    assert abs(gaps["register/register.sample"] - (220e-6 + 370e-6)) < 1e-12
    assert abs(gaps["register/register.forward"] - 120e-6) < 1e-12
    assert abs(gaps["register/register.copy_out"] - 150e-6) < 1e-12


def test_copy_in_reads_the_program_counter(monkeypatch):
    from se3_equi_graph_registration_tpu_torch import serving

    read = run.reader("eval_copy_in_mb")
    r = _reading(_serving_events(), "register")
    monkeypatch.setattr(serving, "counters", {"calls": 4, "bytes_in": 4 * 37_224_448})
    assert read(r) == 37.224448
    monkeypatch.setattr(serving, "counters", {"calls": 0, "bytes_in": 0})
    assert read(r) is None
    monkeypatch.delattr(serving, "counters")
    assert read(r) is None


def test_the_new_metrics_name_their_cells():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    by_name = {m["name"]: m for m in spec["per_layer"]}
    for m in EVAL + ("eval_copy_in_mb",):
        assert by_name[m]["workloads"] == ["3dmatch-eval-b64", "kitti-eval-b64"]
        assert by_name[m]["moves"] == "eval_pairs_per_s"
    for m in TRAIN:
        assert by_name[m]["workloads"] == ["3dmatch-train-b64", "kitti-train-b64"]
        assert by_name[m]["moves"] == "train_pairs_per_s"
    assert by_name["eval_copy_in_mb"]["source"] == "program_counter"
    assert all(by_name[m]["source"] == "program_span" for m in EVAL + TRAIN)


@pytest.mark.card
def test_spans_and_kernels_share_one_clock_on_the_card(card):
    """One traced `register()` on the card at the 3DMatch widths (B=4): the
    B1 k-NN kernel starts after the first `forward.knn` span opens and
    before the call's `register.copy_out` closes."""
    import numpy as np
    import torch

    from benchmark.entries.common import engine_config
    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.train import engine

    config = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                         "equigspr-3dmatch.json")))
    cfg = engine_config(config, "fast")
    model = engine.build_model(cfg, head_mode="eval_fusion", device=card)
    reg = serving.Registrar(model.state_dict(), cfg, head_mode="eval_fusion", device=card)
    pb = make_pair_batch(np.random.default_rng(7), batch=4, n=cfg.num_nodes,
                         feat_dim=cfg.in_node_nf)
    req = (pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat)
    reg.register(*req)
    events = trace.capture(lambda: reg.register(*req, seed=1),
                           lambda: torch.cuda.synchronize(card))
    spans = lambda name: sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                                for e in events if e.get("cat") == "user_annotation"
                                and e["name"] == name)
    knn_spans, copy_out = spans("forward.knn"), spans("register.copy_out")
    assert len(knn_spans) == 2 and len(copy_out) == 1
    b1 = sorted(float(e["ts"]) for e in events
                if e.get("cat") == "kernel" and "knn" in e["name"])
    assert b1, "no B1 kernel in the trace"
    assert knn_spans[0][0] <= b1[0] <= copy_out[0][1]
