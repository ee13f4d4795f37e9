"""Whole runs of every cell on the CPU at a small size: the result line
has the contract's keys, the plain reference agrees with the port's plain
CPU path, and a run without a card, or without the port, prints no
result."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from bench_util import CELLS, one_thread, shrink

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    import torch
    prev = one_thread()
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_on_the_cpu_is_correct_and_well_formed(cell):
    code, result, table = run.run(cell, 2**31 + 5, 0.5, False, device="cpu", edit=shrink(cell))
    assert code == 0
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    spec = run.load_cell(cell)
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert all(set(v) == {"value", "unit"} and v["value"] > 0 for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    # the reference and the port's plain CPU path compute the same function: the first
    # step's gradient and every served answer agree to rounding (later steps' losses
    # amplify rounding through the saturated Kabsch weights, within the cell's limits)
    close = ("grad_gap",) if "train" in cell else tuple(table)
    assert all(table[k]["value"] <= 1e-5 for k in close), table
    json.dumps(result)


def _bench(args, cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _bench(["--workload", "3dmatch-train-b64", "--seed", "1", "--seconds", "1",
                  "--trace", "0"], ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _bench(["--workload", "3dmatch-eval-b64", "--seed", "1", "--seconds", "1",
                  "--trace", "1"], tmp_path)
    assert out.returncode != 0 and out.stdout == ""
