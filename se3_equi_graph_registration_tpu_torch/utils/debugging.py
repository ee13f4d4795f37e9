"""Debugging / failure-detection helpers (counterpart of `utils/debugging.py`).

The reference leaves `torch.autograd.set_detect_anomaly(True)` permanently on
inside its train step (a large slowdown, SURVEY.md §5.1) and its only failure
handling is skipping None batches. Here the equivalents are explicit, opt-in,
and cheap when off:

- `nan_checks(True)` turns on autograd's anomaly detection (a backward that
  produces NaN raises, naming the forward op that made it);
- `tree_all_finite(tree)` / `find_nonfinite(tree)` over a `state_dict`, an
  optimizer's state or any nest of dicts, lists and tuples of tensors;
- `guard_fit(...)` wraps the training loop with emergency checkpointing so a
  crash (preemption, data corruption, NaN blowup) saves a resumable state
  through the port's `train.checkpoints.TrainCheckpointer`.
"""
from __future__ import annotations

import traceback
from typing import Any, Callable, Iterator

import torch


def nan_checks(enable: bool = True) -> None:
    """Global NaN trap: autograd anomaly detection, on or off."""
    torch.autograd.set_detect_anomaly(enable)


def _float_leaves(tree: Any, path: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _float_leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _float_leaves(v, f"{path}[{i}]")


def tree_all_finite(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every floating-point tensor in the nest is finite.
    Stays on the tensors' device (no host fetch); True for a nest without
    floating-point tensors."""
    flags = [torch.isfinite(t).all() for _, t in _float_leaves(tree)]
    if not flags:
        return torch.tensor(True)
    return torch.stack([f.to(flags[0].device) for f in flags]).all()


def find_nonfinite(tree: Any) -> list[str]:
    """Host-side: paths (`['egnn.gcl_0.node_mlp_0.weight']`,
    `['state'][3]['exp_avg']`, ...) of the tensors holding a non-finite
    value, for post-mortem reports."""
    return [path for path, t in _float_leaves(tree) if not bool(torch.isfinite(t).all())]


def guard_fit(fit_fn: Callable, checkpointer, state_getter: Callable):
    """Run `fit_fn()`; on ANY exception save an emergency checkpoint of
    `state_getter()` (an `engine.TrainState`) before re-raising. Returns
    fit_fn's result."""
    try:
        return fit_fn()
    except BaseException:
        try:
            state = state_getter()
            step = int(state.step) if hasattr(state, "step") else 0
            checkpointer.save(step, state, metrics={"emergency": 1.0})
            print(f"[guard_fit] emergency checkpoint saved at step {step}")
        except Exception:
            traceback.print_exc()
        raise
