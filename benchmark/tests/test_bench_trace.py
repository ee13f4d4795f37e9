"""The trace's reduction and the per-layer readers on a made-up trace."""
import json
import os

from benchmark import run, trace, work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _events():
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    return [ev("user_annotation", "window", 0.0, 1000.0),
            ev("user_annotation", "step", 10.0, 400.0),
            ev("cpu_op", "aten::sort", 120.0, 50.0),
            ev("user_annotation", "step", 500.0, 450.0),
            ev("kernel", "void egcl_bwd_tile_f32_kernel<32>(float const*)", 100.0, 100.0),
            ev("kernel", "void egcl_tile_f32_kernel<32>(float const*)", 150.0, 100.0),
            ev("kernel", "knn_exact_warp_kernel(float const*)", 600.0, 50.0),
            ev("kernel", "knn_chunked_warp_kernel(float const*)", 700.0, 10.0),
            ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 800.0, 100.0),
            ev("kernel", "late", 2000.0, 5.0)]              # outside the window


def test_union_idle_and_launches():
    r = trace.Reading(_events(), 2, None, 0.01, ("step", "copy_batch"))
    assert r.launches == 5 and abs(r.window_s - 1e-3) < 1e-12
    assert abs(r.busy_s - 310e-6) < 1e-12            # [100, 250] ∪ [600, 650] ∪ [700, 710] ∪ [800, 900]
    assert abs(r.kernel_s(r"knn", r"chunked") - 50e-6) < 1e-12
    assert r.kernel_s(r"nothing") is None
    b = r.breakdown()
    name, seconds = b["device_ops"][0]
    assert name == "void egcl_bwd_tile_f32_kernel<32>(float const*)" and abs(seconds - 1e-4) < 1e-12
    gaps = dict(b["idle_gaps"])      # by the span at each gap's middle: 50, 425, 675, 755, 950
    assert set(gaps) == {"step", "outside"}
    assert abs(gaps["step"] - 240e-6) < 1e-12 and abs(gaps["outside"] - 450e-6) < 1e-12
    # idle: a call's device time (155 us) over a call's untraced host time (10 ms)
    for name in ("device_idle_pct.train", "device_idle_pct.eval"):
        assert abs(run.reader(name)(r) - 100.0 * (1.0 - 155e-6 / 0.01)) < 1e-9


def test_a_metric_is_read_by_its_own_file_or_its_name_without_the_suffix():
    assert run.reader("knn_roofline.train").__module__ == "benchmark_metric_knn_roofline.train"
    assert run.reader("train_mfu").__code__.co_filename.endswith("metrics/train_mfu.py")
    for name in ("knn_roofline.eval", "egcl_fwd_roofline.eval", "egcl_bwd_roofline.train"):
        assert run.reader(name).__code__.co_filename.endswith(
            f"metrics/{name.rsplit('.', 1)[0]}.py")


def test_readers_never_pass_100_on_the_least_time():
    model = json.load(open(os.path.join(ROOT, "benchmark", "configs", "equigspr-3dmatch.json")))
    shapes = work.Shapes(model, True, 64, 384)
    least = work.least_s(*reversed(shapes.egcl_bwd()), work.PEAK_FP32)
    ev = [{"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0.0, "dur": 1e6},
          {"ph": "X", "cat": "kernel", "name": "egcl_bwd_tile_f32_kernel", "ts": 0.0,
           "dur": least * 1e6}]
    r = trace.Reading(ev, 1, shapes, 1.0, ("step",))
    assert abs(run.reader("egcl_bwd_roofline.train")(r) - 100.0) < 1e-6
    assert run.reader("knn_roofline.train")(r) is None       # no k-NN kernel: silent
    assert 0 < run.reader("train_mfu")(r) < 100
