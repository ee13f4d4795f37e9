"""Metrics logging / observability (a copy of the JAX package's
`utils/logging.py`, which cannot be imported without jax).

The reference creates a TensorBoard SummaryWriter and never writes to it, and
imports wandb without initializing it (SURVEY.md §5.5). Here logging is a
real subsystem: a `MetricsLogger` that fans out to JSONL (machine-readable,
resumable), CSV, and stdout; TensorBoard event files are emitted too when a
writer implementation is importable (tensorboardX / torch.utils.tensorboard),
and skipped silently otherwise — no hard dependency.
"""
from __future__ import annotations

import csv
import json
import os
import time
from typing import Mapping, Optional


def _try_tensorboard(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter  # torch-cpu ships it
        return SummaryWriter(logdir)
    except Exception:
        try:
            from tensorboardX import SummaryWriter
            return SummaryWriter(logdir)
        except Exception:
            return None


class MetricsLogger:
    def __init__(self, logdir: str, stdout: bool = True,
                 tensorboard: bool = True):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._csv_path = os.path.join(logdir, "metrics.csv")
        self._csv_file = None
        self._csv_writer = None
        self._stdout = stdout
        self._tb = _try_tensorboard(logdir) if tensorboard else None
        self._t0 = time.time()

    def log(self, step: int, metrics: Mapping[str, float],
            prefix: Optional[str] = None) -> None:
        rec = {("%s/%s" % (prefix, k) if prefix else k): float(v)
               for k, v in metrics.items()}
        rec_full = {"step": int(step), "wall_s": round(time.time() - self._t0, 3),
                    **rec}
        self._jsonl.write(json.dumps(rec_full) + "\n")
        self._jsonl.flush()

        if self._csv_writer is None:
            self._csv_file = open(self._csv_path, "a", newline="")
            self._csv_writer = csv.DictWriter(self._csv_file,
                                              fieldnames=list(rec_full))
            if self._csv_file.tell() == 0:
                self._csv_writer.writeheader()
        try:
            self._csv_writer.writerow(rec_full)
            self._csv_file.flush()
        except ValueError:
            pass  # metric set changed mid-run; JSONL remains authoritative

        if self._tb is not None:
            for k, v in rec.items():
                self._tb.add_scalar(k, v, step)
        if self._stdout:
            pretty = ", ".join(f"{k}={v:.4f}" for k, v in rec.items())
            print(f"[step {step}] {pretty}", flush=True)

    def close(self) -> None:
        self._jsonl.close()
        if self._csv_file:
            self._csv_file.close()
        if self._tb is not None:
            self._tb.close()
