"""Multi-host training quickstart, the distributed launch pattern (the
port's twin of the JAX package's `examples/multihost_train.py`).

Run one copy a card, under torchrun or with explicit arguments:

    torchrun --nproc_per_node=<cards> -m \\
        se3_equi_graph_registration_tpu_torch.examples.multihost_train
    # host 0                                   # host 1
    python -m se3_equi_graph_registration_tpu_torch.examples.multihost_train \\
        --coordinator host0:9876 --num-processes 2 --process-id 0    # ... --process-id 1

Every process joins the process group (`parallel.init_distributed`: NCCL on
the card, gloo on the CPU), builds one mesh whose 'data' axis spans every
process (`parallel.global_mesh`), feeds its own slice of the dataset
(`PairLoader(process_shard=...)`) and runs `engine.fit(mesh=...)`, which
sums the gradients over the processes. Each process prints the global
batch's loss.

`--demo` spawns 2 local gloo processes on the CPU and runs the whole flow
on this machine.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np

PAIRS = 16


class DemoDataset:
    """Deterministic synthetic pairs; replace with ThreeDMatchPairDataset or
    KITTIPairDataset pointed at an archive root."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return PAIRS

    def __getitem__(self, i):
        from ..data.synthetic import make_pair_batch

        pb = make_pair_batch(np.random.default_rng(i), batch=1, n=self.n, feat_dim=16)
        return tuple(np.asarray(v)[0] for v in pb)


def worker(coordinator: Optional[str], num_processes: Optional[int],
           process_id: Optional[int], epochs: int, n: int, device=None) -> list:
    """One process of the data-parallel run; returns the loss of each epoch
    (the global batch's, the same on every process)."""
    import torch

    from ..data.pipeline import PairLoader
    from ..device import resolve_device
    from ..parallel import global_mesh, init_distributed, process_shard_info
    from ..train import engine

    dev = resolve_device(device)
    init_distributed(coordinator, num_processes, process_id, device=dev)
    pid, nproc = process_shard_info()
    cfg = engine.EngineConfig(num_nodes=n, k=8, in_node_nf=16, hidden_nf=32, top_k=16, lr=1e-3)
    mesh = global_mesh(device=dev)                # 'data' over every process
    loader = PairLoader(DemoDataset(n), batch_size=PAIRS // nproc, shuffle=True, seed=0,
                        num_workers=1, process_shard=(pid, nproc))
    state = engine.init_state(cfg, torch.Generator().manual_seed(0), device=dev)
    logs = []
    engine.fit(state.model, state.optimizer, cfg, state, train_batches=lambda: loader,
               epochs=epochs, mesh=mesh, logger=lambda e, m: logs.append(m["total"]))
    print(f"process {pid}/{nproc}: loss {logs[0]:.4f} -> {logs[-1]:.4f}", flush=True)
    return logs


def demo(epochs: int, n: int) -> list:
    """Spawn 2 local CPU processes (gloo) and run the multi-host flow;
    returns each process's losses, which must be equal."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 2) // 2)))   # share the cores
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"losses{i}.json") for i in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", __spec__.name, "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(i), "--epochs", str(epochs),
             "--n", str(n), "--device", "cpu", "--losses-out", outs[i]], env=env)
            for i in range(2)]
        try:
            rcs = [p.wait(timeout=540) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if rcs != [0, 0]:
            raise RuntimeError(f"demo: the processes exited with {rcs}")
        losses = [json.load(open(path)) for path in outs]
    if losses[0] != losses[1]:
        raise RuntimeError(f"demo: the processes' losses differ: {losses}")
    print("demo: both processes finished")
    return losses


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0's store (default: torchrun's MASTER_ADDR:"
                         "MASTER_PORT)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help=">0: run on the CPU (gloo), as --device cpu")
    ap.add_argument("--demo", action="store_true", help="spawn 2 local CPU processes")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' with gloo)")
    ap.add_argument("--losses-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.demo:
        return demo(args.epochs, args.n)
    logs = worker(args.coordinator, args.num_processes, args.process_id, args.epochs, args.n,
                  "cpu" if args.cpu_devices > 0 else args.device)
    if args.losses_out:
        with open(args.losses_out, "w") as f:
            json.dump(logs, f)
    return logs


if __name__ == "__main__":
    main()
