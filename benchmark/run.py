#!/usr/bin/env python3
"""The benchmark of the PyTorch / CUDA port: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from BENCHMARK.json at the checkout's root: the
cell's configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`, read by `traffic/generator.py`), its own file
(`workloads/<cell>.json`: the engine path, the warm-up and check sizes,
the limits of the comparison) and one reader a metric
(`metrics/<metric>.py`). The mix's `entry` names the module
(`entries/<entry>.py`) that builds the program under test and calls it.

A run: set-up (the kernels built or loaded from the program's own build
directory in the checkout, weights and requests drawn from the seed on the
device, the first steps, the warm-up), then a closed-loop window of
`--seconds`; with `--trace 1` a traced window of the cell's `trace_calls`
calls comes first and the per-layer metrics are printed instead of the
end-to-end ones. After the window: the peak memory, the program's state
freed, the plain reference over what the window's path produced, the
verdict. The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error.
"""
from __future__ import annotations

import os
import time

T_START = time.perf_counter()
if __name__ == "__main__":
    # one thread of host arithmetic a run: numpy's BLAS and OpenMP pools read these
    # when they load, so they are set before anything imports numpy or torch
    for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[_var] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import guard  # noqa: E402
from benchmark.traffic import generator  # noqa: E402


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> SimpleNamespace:
    """The cell `name` of `root`/BENCHMARK.json with its files read: its
    entry, configuration, mix, own file, and its metrics by kind."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    here = lambda rel: os.path.join(root, rel)
    mine = lambda m: name in m.get("workloads", [name])
    return SimpleNamespace(
        name=name, entry=entry, chips=entry["chips"],
        config=_json(here(config["file"])),
        mix=generator.load_mix(entry["traffic"]),
        cell=_json(os.path.join(HERE, "workloads", f"{name}.json")),
        end_to_end=[m for m in spec["end_to_end"] if mine(m)],
        per_layer=[m for m in spec["per_layer"] if mine(m)])


def reader(metric: str):
    """The `read` function of `metrics/<metric>.py`, or of the file named
    without the metric's last suffix (`device_idle_pct.train` is read by
    `metrics/device_idle_pct.py` unless a file of its own exists)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    if not os.path.exists(path) and "." in metric:
        path = os.path.join(HERE, "metrics", f"{metric.rsplit('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_query():
    """nvidia-smi reading the card's name and power limit, started in the
    background; `card_line` waits for it."""
    try:
        return subprocess.Popen(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
    except OSError as e:
        return e


def card_line(query) -> str:
    if isinstance(query, OSError):
        return f"nvidia-smi: {query}"
    try:
        out = query.communicate(timeout=60)[0].strip().splitlines()
    except subprocess.TimeoutExpired:
        query.kill()
        query.communicate()
        return "nvidia-smi: no answer in 60 s"
    return out[0] if out else "nvidia-smi: no output"


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def where() -> str:
    """The CPUs this process may run on and the one its main thread is on."""
    try:
        with open("/proc/thread-self/stat") as f:
            cpu = f.read().rsplit(")", 1)[1].split()[36]
    except (OSError, IndexError):
        cpu = "?"
    return f"{len(os.sched_getaffinity(0))} CPUs allowed, main thread on CPU {cpu}"


def run(name: str, seed: int, seconds: float, trace: bool, device=None,
        edit=None, root: str = ROOT, look=None) -> tuple[int, dict | None, dict]:
    """One run of cell `name`: (exit code, the result or None, the numbers
    compared with their limits). `device` None means the CUDA card (the
    run refuses to start without the cell's cards); `edit(cell)` may change
    the cell's files' values before anything is built (tests shrink them);
    `look(entry, reference)`, called once the reference has run, reads
    more than the comparison does (calibrate.py: the control's numbers)."""
    children = []
    try:
        return _run(name, seed, seconds, trace, device, edit, root, look, children)
    finally:
        for p in children:              # nvidia-smi, if it is still running
            if p.poll() is None:
                p.kill()
            p.wait()


def _run(name, seed, seconds, trace, device, edit, root, look, children):
    import torch

    from benchmark import trace as tracing, work
    from benchmark.check import verdict

    c = load_cell(name, root)
    if edit is not None:
        edit(c)
    query = None
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
            log(f"{name} needs {c.chips} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2, None, {}
        device = torch.device("cuda", 0)
        query = card_query()
        if not isinstance(query, OSError):
            children.append(query)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}; imports done at "
            f"{time.perf_counter() - T_START:.2f} s; {where()}")
        from se3_equi_graph_registration_tpu_torch.ops.kernels import build
        built = build.build_all()
        log(f"kernels built this run: {sorted(built) or 'none (all in the build directory)'}; "
            f"at {time.perf_counter() - T_START:.2f} s")
    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.set_num_threads(1)        # one process, few threads: the host work is one thread's
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)

    ctx = SimpleNamespace(config=c.config, mix=c.mix, cell=c.cell, seed=seed, device=device,
                          mark=lambda what: log(f"set-up: {what} at "
                                                f"{time.perf_counter() - T_START:.2f} s"))
    drv = importlib.import_module(f"benchmark.entries.{c.mix['entry']}").Entry(ctx)
    drv.setup()
    sync()
    setup_s = time.perf_counter() - T_START
    log(f"set-up: done at {setup_s:.2f} s")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    shapes = work.Shapes(c.config, c.cell["engine"] == "accurate", c.mix["batch"],
                         c.config.get("egnn_window", c.config["num_nodes"]))

    state = {"i": drv.next, "failed": 0}

    def one_call():
        try:
            drv.call(state["i"])
        except Exception as e:          # a failed call counts its pairs and the run goes on
            state["failed"] += drv.pairs_per_call
            log(f"call {state['i']} failed: {type(e).__name__}: {e}")
        state["i"] += 1

    events = None
    if trace:
        n_traced = c.cell["trace_calls"]
        events = tracing.capture(lambda: [one_call() for _ in range(n_traced)], sync)
    start = state["i"]
    stamps = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        one_call()
        stamps.append(time.perf_counter() - t0)
    sync()
    window_s = time.perf_counter() - t0
    calls = state["i"] - start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    fifths = [sum(1 for t in stamps if k * seconds / 5 <= t < (k + 1) * seconds / 5)
              for k in range(5)]
    log(f"window: {calls} calls in {window_s:.4f} s (calls returned a fifth of the window: "
        f"{fifths}); launches by route {drv.counters()}; {where()}")

    drv.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = drv.reference()
    numbers = drv.numbers(drv.program, ref)
    correct, table = verdict(numbers, c.cell["limits"])
    if look is not None:
        look(drv, ref)
    correct = correct and state["failed"] == 0

    if query is not None:
        log(f"card: {card_line(query)}")
    found = guard.jax_modules()
    if found:
        log(f"the run loaded JAX or the JAX package: {found}")
        return 3, None, table

    win = SimpleNamespace(setup_s=setup_s, pairs=calls * drv.pairs_per_call,
                          failed=state["failed"], seconds=window_s)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": c.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": win.pairs, "failed": win.failed}
    if trace:
        r = tracing.Reading(events, c.cell["trace_calls"], shapes, window_s / max(calls, 1),
                            (drv.span, "copy_batch"))
        metrics = {}
        for m in c.per_layer:
            v = reader(m["name"])(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=r.busy_s, window_s=r.window_s)
        result.update(metrics=metrics, device=dev, breakdown=r.breakdown())
    else:
        result.update(metrics={m["name"]: {"value": reader(m["name"])(win), "unit": m["unit"]}
                               for m in c.end_to_end}, device=dev)
    result["checks"] = table
    return 0, result, table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    code, result, table = run(a.workload, a.seed, a.seconds, bool(a.trace))
    if result is not None:
        print(json.dumps(result), flush=True)
    for k, v in table.items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    return code


if __name__ == "__main__":
    sys.exit(main())
