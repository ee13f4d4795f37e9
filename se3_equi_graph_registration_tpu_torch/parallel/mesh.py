"""Meshes of ranks and pair sharding (counterpart of `parallel/mesh.py`).

The JAX package lays a `jax.sharding.Mesh` over devices and lets XLA insert
the collectives. The port keeps PyTorch's idiom: one process a card, each
rank with its own device, `torch.distributed` for the collectives (gloo on
the CPU, NCCL on cards). A `Mesh` names the axes over the ranks of the
default process group:

  'data'  — pair-batch data parallelism: each rank runs its rows of the pair
            batch; results are gathered (`gather_pairs`), gradients summed;
  'point' — point-axis sharding of dense clouds: each rank holds a slab of
            every cloud's rows (parallel/point_sharding.py); the slabs meet
            through `all_gather_rows` or the ±halo ring of `halo_extend`.

Ranks lie on the axes row-major, in the order the axes are given, as the
JAX package reshapes its device list: on {"data": Dd, "point": Dp} rank
d·Dp + p holds data index d and point index p. Each axis's collectives run
on the group of the ranks that differ only along it (`Mesh.group`); the
ranks of one data row hold the same pairs, so the data-axis collectives
count `axis_size("data")` ranks, not the world.

Without an initialized process group a mesh has one rank and every
collective is the identity; with one, every collective along an axis that
spans the whole world goes through the group, a world of one included. An
axis the mesh lacks has size 1 (its leaves are replicated).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "point")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axis sizes over the ranks of the default process group, this
    rank, the group's backend (None without a group), the device this rank
    computes on (None: any) and, for each axis whose collectives go through
    a process group, the group of this rank's line along it."""
    axes: Mapping[str, int]
    rank: int
    backend: Optional[str]
    device: Optional[torch.device]
    groups: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def size(self) -> int:
        """Ranks on the mesh."""
        return math.prod(self.axes.values())

    def axis_size(self, axis: str) -> int:
        """Ranks along `axis` (1 for an axis the mesh lacks)."""
        return self.axes.get(axis, 1)

    def _coords(self) -> list[int]:
        """This rank's index along each axis (row-major over the ranks)."""
        return [int(c) for c in np.unravel_index(self.rank, tuple(self.axes.values()))]

    def axis_index(self, axis: str) -> int:
        """This rank's index along `axis` (0 for an axis the mesh lacks)."""
        return self._coords()[list(self.axes).index(axis)] if axis in self.axes else 0

    def shifted_rank(self, axis: str, shift: int) -> int:
        """The global rank `shift` steps along `axis` from this one, around
        the ring."""
        coords, i = self._coords(), list(self.axes).index(axis)
        coords[i] = (coords[i] + shift) % self.axes[axis]
        return int(np.ravel_multi_index(coords, tuple(self.axes.values())))

    def group(self, axis: str):
        """The process group of this rank's line along `axis`, or None when
        collectives along it are the identity: no process group, an axis the
        mesh lacks, or one of size 1 in a larger world."""
        return self.groups.get(axis) if self.distributed else None

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
    mesh = Mesh(axes, rank, backend, device, _axis_groups(axes, world, rank, backend))
    if device is not None:
        mesh.check_device(device)
    return mesh


def _axis_groups(axes: Mapping[str, int], world: int, rank: int, backend: Optional[str]):
    """{axis: this rank's group along it} for the axes whose collectives
    need one: the default group for an axis spanning the world, a new group
    for each line of an axis of size > 1 that does not. Every rank creates
    every group, in the same order (`new_group` is collective), so every
    rank must build its meshes in the same order too."""
    if backend is None:
        return {}
    ranks = np.arange(world).reshape(tuple(axes.values()))
    groups = {}
    for i, (name, size) in enumerate(axes.items()):
        if size == world:
            groups[name] = dist.group.WORLD
        elif size > 1:
            for line in np.moveaxis(ranks, i, -1).reshape(-1, size):
                group = dist.new_group(line.tolist())
                if rank in line:
                    groups[name] = group
    return groups


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
        n = self.mesh.axis_size(self.axis)
        if b % n:
            raise ValueError(f"a batch of {b} pairs does not split over the mesh's "
                             f"{self.axis!r} axis of {n}")
        per, i = b // n, self.mesh.axis_index(self.axis)
        return slice(i * per, (i + 1) * per)


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


def shard_points_batch(batch: Mapping, mesh: Mesh, data_axis: Optional[str] = "data") -> dict:
    """This rank's block of a pair-batch dict: [B, N, ...] leaves (labels
    [B, N] among them) split into row blocks over `data_axis` and into
    contiguous point slabs over the 'point' axis, gt_pose [B, 4, 4] and
    other per-pair leaves over `data_axis` only. `data_axis=None`: the rows
    are already this rank's (a loader's slice), only the points split."""
    rows = data_sharding(mesh, data_axis) if data_axis else replicated(mesh)
    d, i = mesh.axis_size("point"), mesh.axis_index("point")

    def block(name, a):
        a = a[rows.rows(len(a))]
        if a.ndim < 2 or name == "gt_pose":
            return a
        n = a.shape[1]
        if n % d:
            raise ValueError(f"{n} points do not split over the mesh's 'point' axis of {d}")
        return a[:, i * (n // d):(i + 1) * (n // d)]

    return {k: block(k, v) for k, v in batch.items()}


def gather_pairs(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's rows of x [b, ...] (equal b on every rank),
    concatenated in the order of the 'data' axis on every rank: the whole
    batch's results, as a JAX global array hands them to every process."""
    group = mesh.group("data")
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.axis_size("data"))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) over a group whose backward all-reduces the
    gradient: with y the same sum on every rank and each rank's loss a
    function of y, every rank's x receives the sum of all ranks' dL/dy."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _SumOverRanks.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh], axis: str = "data") -> torch.Tensor:
    """The sum of x over the ranks along `axis`, on each of them (a new
    tensor). Differentiable: its backward sums the gradients over the same
    ranks, so each rank's share of a loss that depends on it reaches every
    rank's inputs."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return x
    return _SumOverRanks.apply(x, group)


class _AllGatherRows(torch.autograd.Function):
    """All-gather of row slabs [..., L, C] along dim -2 into [..., D·L, C];
    its backward is the transpose, a reduce-scatter (sum) of the gradient
    rows: `reduce_scatter_tensor` under NCCL, an all-reduce and this rank's
    slice under gloo, which has no reduce-scatter."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, x.shape[-2]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(mesh.axis_size(axis))]
        dist.all_gather(parts, x.contiguous(), group=mesh.group(axis))
        return torch.cat(parts, dim=-2)

    @staticmethod
    def backward(ctx, g):
        mesh, group, L = ctx.mesh, ctx.mesh.group(ctx.axis), ctx.rows
        if mesh.backend == "nccl":
            full = g.movedim(-2, 0).contiguous()
            out = full.new_empty((L,) + tuple(full.shape[1:]))
            dist.reduce_scatter_tensor(out, full, group=group)
            return out.movedim(0, -2), None, None
        total = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(total, group=group)
        i = mesh.axis_index(ctx.axis)
        return total[..., i * L:(i + 1) * L, :], None, None


def all_gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = "point") -> torch.Tensor:
    """Every rank's slab x [..., L, C] along `axis`, concatenated along the
    rows in axis order: [..., D·L, C] on each rank. Differentiable (its
    backward reduce-scatters the gradient)."""
    if mesh.group(axis) is None:
        return x
    return _AllGatherRows.apply(x, mesh, axis)


def _ring_exchange(to_right: torch.Tensor, to_left: torch.Tensor, mesh: Mesh, axis: str
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Send `to_right` one step up the ring along `axis` and `to_left` one
    step down; returns (what the left neighbour sent right, what the right
    neighbour sent left). On a ring of one the rank is its own neighbour:
    a local copy (torch refuses a send to one's own rank; JAX's ppermute to
    self is the identity)."""
    group = mesh.group(axis)
    if group is None or mesh.axis_size(axis) == 1:
        return to_right, to_left
    right, left = mesh.shifted_rank(axis, 1), mesh.shifted_rank(axis, -1)
    from_left, from_right = torch.empty_like(to_right), torch.empty_like(to_left)
    # tags keep the two directions apart where left and right are one rank
    ops = [dist.P2POp(dist.isend, to_right.contiguous(), right, group, tag=0),
           dist.P2POp(dist.isend, to_left.contiguous(), left, group, tag=1),
           dist.P2POp(dist.irecv, from_left, left, group, tag=0),
           dist.P2POp(dist.irecv, from_right, right, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_left, from_right


class _HaloExtend(torch.autograd.Function):
    """[..., L, C] → [..., W + L + W, C]: the left neighbour's last W rows,
    the slab, the right neighbour's first W rows. The backward is the
    reverse exchange: each received block's gradient goes back to the rank
    that sent it and is added to the rows it came from."""

    @staticmethod
    def forward(ctx, a, mesh, axis, halo):
        ctx.mesh, ctx.axis, ctx.halo = mesh, axis, halo
        from_left, from_right = _ring_exchange(a[..., -halo:, :], a[..., :halo, :], mesh, axis)
        return torch.cat([from_left, a, from_right], dim=-2)

    @staticmethod
    def backward(ctx, g):
        W = ctx.halo
        to_left, to_right = g[..., :W, :], g[..., -W:, :]
        from_left, from_right = _ring_exchange(to_right, to_left, ctx.mesh, ctx.axis)
        grad = g[..., W:-W, :].clone()
        grad[..., :W, :] += from_left
        grad[..., -W:, :] += from_right
        return grad, None, None, None


def halo_extend(a: torch.Tensor, mesh: Mesh, axis: str, halo: int) -> torch.Tensor:
    """Extend a point slab [..., L, C] with its ring neighbours' ±halo
    boundary rows along `axis`: [..., L + 2·halo, C] (the one definition of
    the halo exchange, for the halo EGCL and the halo k-NN). End slabs of
    the curve receive wrap-around rows from the far end, which callers mask
    or never index. Differentiable. 1 <= halo <= L."""
    if not 1 <= halo <= a.shape[-2]:
        raise ValueError(f"halo={halo} must lie in [1, {a.shape[-2]}] (the slab's rows)")
    return _HaloExtend.apply(a, mesh, axis, halo)


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

