"""The control on the card: the plain reference put in the program's place
in the next precision down (TF32 for the accurate path's float32, fp8
operands for the fast path's bf16) comes out not correct under the cell's
limits, at the cell's own size, while the program comes out correct.

    python -m pytest benchmark/tests -m card
"""
import pytest

from benchmark import calibrate, run
from benchmark.check import verdict


@pytest.mark.card
@pytest.mark.parametrize("cell", ["3dmatch-train-b64", "kitti-train-b64", "3dmatch-eval-b64",
                                  "kitti-eval-b64"])
def test_the_control_fails_and_the_program_passes(card, cell):
    limits = run.load_cell(cell).cell["limits"]
    lines = calibrate.readings(cell, [2**31 + 101], 1.0, device=card)
    by_kind = {line["kind"]: line for line in lines}
    assert verdict(by_kind["program"], limits)[0]
    control = "tf32" if "train" in cell else "fp8"
    assert not verdict(by_kind[control], limits)[0]


def test_calibration_reads_through_the_run_on_the_cpu():
    """calibrate.py's readings come from `run.run`'s own path: the program,
    the control, the half-batch fault and the float64 witness, each with
    every number of the comparison."""
    import torch

    from bench_util import shrink
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lines = calibrate.readings("3dmatch-train-b64", [2**31 + 7], 0.2, device="cpu",
                                   edit=shrink("3dmatch-train-b64"))
    finally:
        torch.set_num_threads(prev)
    kinds = [line["kind"] for line in lines]
    assert kinds == ["program", "tf32", "half", "program-vs-float64", "reference-vs-float64"]
    for line in lines:
        assert all(line[k] >= 0 for k in ("loss1_gap", "grad_gap", "change1_gap", "change_gap"))
    by = {line["kind"]: line for line in lines}
    assert by["half"]["loss1_gap"] > by["program"]["loss1_gap"]
    # a step's update of the first gradient: Adam's unit steps, the same either side
    assert by["program"]["change1_gap"] < 1e-3
