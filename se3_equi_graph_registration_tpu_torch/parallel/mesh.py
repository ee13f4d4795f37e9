"""Meshes of ranks and pair sharding (counterpart of `parallel/mesh.py`).

The JAX package lays a `jax.sharding.Mesh` over devices and lets XLA insert
the collectives. The port keeps PyTorch's idiom: one process a card, each
rank with its own device, `torch.distributed` for the collectives (gloo on
the CPU, NCCL on cards). A `Mesh` names the axes over the ranks of the
default process group:

  'data'  — pair-batch data parallelism: each rank runs its rows of the pair
            batch; results are gathered (`gather_pairs`), gradients summed;
  'point' — point-axis sharding, not ported yet (ROADMAP Queue A item 9b).

Without an initialized process group a mesh has one rank and every
collective is the identity; with one, every collective goes through the
group, a world of one included.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data",)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axis sizes over the ranks of the default process group, this
    rank, the group's backend (None without a group) and the device this
    rank computes on (None: any)."""
    axes: Mapping[str, int]
    rank: int
    backend: Optional[str]
    device: Optional[torch.device]

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def size(self) -> int:
        """Ranks on the mesh."""
        return math.prod(self.axes.values())

    @property
    def distributed(self) -> bool:
        """Whether collectives go through a process group (False: one rank,
        every collective the identity)."""
        return self.backend is not None

    def check_device(self, device: torch.device) -> None:
        """Raise ValueError when the group's backend cannot carry tensors of
        `device`: gloo takes CPU tensors here, NCCL CUDA tensors."""
        if self.backend == "gloo" and device.type == "cuda":
            raise ValueError(f"this mesh's process group is gloo, which the port runs on "
                             f"CPU tensors; the call runs on {device}: initialize the group "
                             f"with backend='nccl' for the cards")
        if self.backend == "nccl" and device.type != "cuda":
            raise ValueError(f"this mesh's process group is NCCL, which carries CUDA "
                             f"tensors only; the call runs on {device}")


def make_mesh(axes: Optional[Mapping[str, int]] = None,
              device: Union[str, torch.device, None] = None) -> Mesh:
    """A mesh over every rank of the default process group (one rank when
    none is initialized). axes=None puts every rank on one 'data' axis; the
    sizes must multiply to the world size. `device`: the rank's device
    (default: the current CUDA device under NCCL, the CPU under gloo, any
    without a group)."""
    world, rank, backend = 1, 0, None
    if dist.is_available() and dist.is_initialized():
        world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    axes = {"data": world} if axes is None else dict(axes)
    if "point" in axes:
        raise NotImplementedError(
            f"mesh axes {axes}: point-axis sharding (the JAX package's "
            f"parallel/point_sharding.py) is not ported yet (ROADMAP Queue A item 9b)")
    unknown = [a for a in axes if a not in AXES]
    if unknown:
        raise ValueError(f"mesh axes {axes}: the port's meshes take the axes {AXES}")
    need = math.prod(axes.values())
    if need != world:
        raise ValueError(f"mesh axes {axes} need {need} devices, have {world}")
    if device is not None:
        device = torch.device(device)
    elif backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    elif backend is not None:
        device = torch.device("cpu")
    mesh = Mesh(axes, rank, backend, device)
    if device is not None:
        mesh.check_device(device)
    return mesh


def check_mesh(mesh: Any, device: torch.device) -> Mesh:
    """`mesh` if it is a Mesh whose group carries `device`'s tensors;
    TypeError for anything else, ValueError for a backend that cannot."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh / global_mesh), "
                        f"got {type(mesh).__name__}")
    mesh.check_device(device)
    return mesh


class Sharding(NamedTuple):
    """How a [B, ...] leaf lies on a mesh: split over `axis` in contiguous
    blocks of rows in rank order, or replicated (axis None)."""
    mesh: Mesh
    axis: Optional[str]

    def rows(self, b: int) -> slice:
        """This rank's rows of a batch of b."""
        if self.axis is None:
            return slice(0, b)
        n = self.mesh.axes[self.axis]
        if b % n:
            raise ValueError(f"a batch of {b} pairs does not split over the mesh's "
                             f"{self.axis!r} axis of {n}")
        per = b // n
        return slice(self.mesh.rank * per, (self.mesh.rank + 1) * per)


def data_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Sharding for [B, ...] leaves: the batch dim split over `axis`."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def _map_leaves(fn, tree):
    if isinstance(tree, Mapping):
        return type(tree)((k, _map_leaves(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def shard_pair_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's rows of every [B, ...] leaf (numpy arrays or tensors) of
    a dict, tuple or list: the contiguous block `data_sharding(mesh,
    axis).rows(B)`. B must split evenly over the axis."""
    sharding = data_sharding(mesh, axis)
    return _map_leaves(lambda a: a[sharding.rows(len(a))], batch)


def pad_pairs(batch, multiple: int):
    """Every [B, ...] leaf (numpy or tensors) padded to a multiple of
    `multiple` rows by repeating its last row."""
    def rep(a):
        pad = -len(a) % multiple
        if not pad:
            return a
        if torch.is_tensor(a):
            return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))])
        return np.concatenate([a, np.repeat(a[-1:], pad, 0)])
    return _map_leaves(rep, batch)


def gather_pairs(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of x [b, ...] (equal b on every rank), concatenated
    in rank order on every rank: the whole batch's results, as a JAX global
    array hands them to every process."""
    if not mesh.distributed:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the gradient: with y the
    same sum on every rank and each rank's loss a function of y, every
    rank's x receives the sum of all ranks' dL/dy."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _SumOverRanks.apply(g)


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of x over the mesh's ranks, on every rank (a new tensor).
    Differentiable: its backward sums the gradients over the ranks, so each
    rank's share of a loss that depends on it reaches every rank's inputs."""
    if mesh is None or not mesh.distributed:
        return x
    return _SumOverRanks.apply(x)


def all_reduce_min(value: int, mesh: Mesh) -> int:
    """The smallest of every rank's `value`."""
    if not mesh.distributed:
        return value
    t = torch.tensor([value], device=mesh.device or "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def all_reduce_sum_(tensors: list, mesh: Mesh) -> None:
    """Sum every tensor over the mesh's ranks, in place, as one all-reduce
    of their concatenation (one dtype)."""
    if not mesh.distributed or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def broadcast_(tensors, mesh: Mesh, src: int = 0) -> None:
    """Overwrite every tensor with rank `src`'s values, in place."""
    if not mesh.distributed:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src)


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.distributed:
        dist.barrier()

