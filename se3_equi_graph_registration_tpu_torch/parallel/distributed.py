"""Multi-process execution (counterpart of `parallel/distributed.py`).

One process a card, `torch.distributed` between them:

- `init_distributed()` — `torch.distributed.init_process_group` from
  torchrun's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
  `MASTER_ADDR`, `MASTER_PORT`) or explicit arguments; NCCL when the
  caller's device is CUDA, gloo otherwise; a no-op on one process;
- `global_mesh()` — a mesh over every rank (parallel/mesh.py);
- `host_local_to_global()` — the global batch from each rank's local slice;
- `process_shard_info()` — (rank, world) for `PairLoader(process_shard=...)`
  (data/pipeline.py), which gives each rank its slice of one seeded shuffle.

    torchrun --nproc_per_node=<cards> -m se3_equi_graph_registration_tpu_torch.train.cli \\
        train --preset 3dmatch

Everything degrades to a no-op on a single process, so one train script runs
from one card to many.
"""
from __future__ import annotations

import datetime
import os
from typing import Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, _map_leaves, gather_pairs, make_mesh


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: Union[str, torch.device, None] = None,
                     timeout_s: float = 300.0) -> bool:
    """Join the process group if this looks like a multi-process run.

    Returns True when more than one process is in the group. Safe to call
    again (it reports the live group) and on one process with no address
    (a no-op, False). `coordinator_address` is host:port of rank 0's store
    (default MASTER_ADDR:MASTER_PORT); `num_processes` and `process_id`
    default to WORLD_SIZE and RANK. An explicit address with one process
    still makes a group (a world of one). `backend` defaults to NCCL when
    `device` (default: the card when there is one) is CUDA, else gloo; under
    NCCL each process takes the card LOCAL_RANK (default: its rank modulo
    the cards). A store that cannot be reached within `timeout_s` raises:
    the process never carries on alone."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            f"a multi-process run needs the coordinator's address, the process count and "
            f"this process's rank (got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r}); set MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK or pass them")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1


def process_shard_info() -> tuple[int, int]:
    """(rank, world size) for data-loader sharding; (0, 1) on one process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(axes: Optional[Mapping[str, int]] = None,
                device: Union[str, torch.device, None] = None) -> Mesh:
    """A mesh over every rank of the group (default: one 'data' axis). The
    JAX package's `dcn_axis` has no counterpart: NCCL picks its own rings
    across hosts and cards."""
    return make_mesh(axes, device)


def host_local_to_global(batch, mesh: Mesh, axis: str = "data"):
    """The global batch on every rank, from each rank's local slice of every
    [b, ...] leaf (numpy arrays or tensors, equal b on every rank),
    concatenated in rank order (`gather_pairs`). On one process it is the
    batch itself."""
    if axis not in mesh.axes:
        raise ValueError(f"axis {axis!r} not in mesh axes {mesh.shape}")
    dev = mesh.device or torch.device("cpu")

    def put(a):
        if torch.is_tensor(a):
            return gather_pairs(a, mesh)
        return gather_pairs(torch.as_tensor(np.asarray(a)).to(dev), mesh).cpu().numpy()

    return _map_leaves(put, batch)
