"""Point-axis sharding for dense 8-16K-point clouds (counterpart of
`parallel/point_sharding.py`; BASELINE.json config 5, "Dense scaling:
8K-16K pts/frame").

Each rank of the mesh's 'point' axis holds a contiguous slab of L = N/D rows
of every cloud (`shard_points_batch`), one process a card, with
`torch.distributed` between them:

- `sharded_knn(_batched)`: the slab all-gathers the whole cloud over the
  point axis and finds each of its rows' exact k nearest among all N
  (`ops/knn.pairwise_sq_dists` in float32 matrix products, ties at the
  lowest index as `lax.top_k` breaks them); ids are global;
- `halo_sharded_knn(_batched)`: over a curve-sorted cloud, each slab sees
  only its ring neighbours' ±halo boundary rows (`halo_extend`), and ids
  outside [0, N) (the curve's ends wrapping round) are masked out;
- `sharded_egnn_forward(_batched)` / `halo_sharded_egnn_forward(_batched)`:
  the EGNN in slab mode (models/egnn.py), 'center' aggregation onto the
  local rows, so no scatter crosses ranks;
- `make_point_sharded_train_step`: the 2-axis (data x point) train step.

The graph builders and the slab EGNN are plain torch ops, as the JAX
package's are XLA ops (its slab EGNN is not its Pallas EGCL, its k-NN not
its Pallas k-NN). JAX's `shard_map` transposes the collectives for the
backward; here `all_gather_rows` and `halo_extend` (parallel/mesh.py) are
autograd Functions whose backwards are the reduce-scatter and the reverse
ring exchange.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import morton
from ..ops.knn import pairwise_sq_dists, smallest_k
from ..ops.numerics import fp32_matmuls
from .mesh import Mesh, Sharding, all_gather_rows, halo_extend, shard_points_batch  # noqa: F401

POINT = "point"


def _slab_knn(x_loc: torch.Tensor, cand: torch.Tensor, k: int, offset: int, n: int
              ) -> torch.Tensor:
    """The k nearest of `cand` [B, M, 3] to each row of x_loc [B, L, 3], as
    global ids (candidate j is global row j + offset); candidates outside
    [0, n) are never chosen."""
    with fp32_matmuls():
        d2 = pairwise_sq_dists(x_loc, cand)
    gids = torch.arange(cand.shape[-2], device=cand.device) + offset
    d2 = d2.masked_fill(((gids < 0) | (gids >= n))[None, None, :], float("inf"))
    return (smallest_k(d2, k) + offset).to(torch.int32)


def sharded_knn_batched(x: torch.Tensor, k: int, mesh: Mesh) -> torch.Tensor:
    """Exact k-NN of this rank's slab x [B, L, 3] (its rows of the batch,
    its points of each cloud) against the whole clouds, gathered over the
    point axis once: nbr_idx [B, L, K] int32, global ids."""
    return _slab_knn(x, all_gather_rows(x, mesh, POINT), k, 0,
                     x.shape[-2] * mesh.axis_size(POINT))


def sharded_knn(x: torch.Tensor, k: int, mesh: Mesh) -> torch.Tensor:
    """k-NN over a replicated cloud x [N, 3] (every rank passes all of it)
    with the queries sharded on the point axis: this rank's slab of
    nbr_idx, [N/D, K] int32, global ids."""
    n, d = x.shape[0], mesh.axis_size(POINT)
    if n % d:
        raise ValueError(f"N={n} must divide over the {d} ranks of the point axis")
    L, i = n // d, mesh.axis_index(POINT)
    return _slab_knn(x[None, i * L:(i + 1) * L], x[None], k, 0, n)[0]


def halo_sharded_knn_batched(x_sorted: torch.Tensor, k: int, mesh: Mesh,
                             halo: int) -> torch.Tensor:
    """Halo k-NN of this rank's slab x_sorted [B, L, 3] of curve-sorted
    clouds: each row's k nearest among the slab and its neighbours' ±halo
    boundary rows, global ids, every one within ±halo of the slab. The
    wrap-around rows the curve's end slabs receive are masked, so those
    slabs see L + halo candidates."""
    L = x_sorted.shape[-2]
    offset = mesh.axis_index(POINT) * L - halo
    return _slab_knn(x_sorted, halo_extend(x_sorted, mesh, POINT, halo), k, offset,
                     L * mesh.axis_size(POINT))


def halo_sharded_knn(x_sorted: torch.Tensor, k: int, mesh: Mesh, halo: int) -> torch.Tensor:
    """`halo_sharded_knn_batched` of one cloud: this rank's slab [L, 3] →
    [L, K]."""
    return halo_sharded_knn_batched(x_sorted[None], k, mesh, halo)[0]


def sharded_egnn_forward_batched(model, h: torch.Tensor, x: torch.Tensor,
                                 nbr_idx: torch.Tensor, mesh: Mesh
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The EGNN `model` (models/egnn.EGNN, 'center') on this rank's slabs
    h [B, L, C], x [B, L, 3], nbr_idx [B, L, K] (global ids), the node
    tables all-gathered once a layer → its slabs of (h, x). Differentiable:
    the gradients of the parameters are this slab's share."""
    with fp32_matmuls():
        return model(h, x, nbr_idx, Sharding(mesh, POINT))


def sharded_egnn_forward(model, h: torch.Tensor, x: torch.Tensor, nbr_idx: torch.Tensor,
                         mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """`sharded_egnn_forward_batched` of one cloud's slab [L, ·]."""
    h2, x2 = sharded_egnn_forward_batched(model, h[None], x[None], nbr_idx[None], mesh)
    return h2[0], x2[0]


def halo_sharded_egnn_forward_batched(model, h: torch.Tensor, x: torch.Tensor,
                                      nbr_idx: torch.Tensor, mesh: Mesh, halo: int
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The EGNN on curve-sorted slabs with a graph from
    `halo_sharded_knn_batched(..., halo)`: each layer exchanges only the
    ±halo boundary rows with the ring neighbours."""
    with fp32_matmuls():
        return model(h, x, nbr_idx, Sharding(mesh, POINT), halo)


def halo_sharded_egnn_forward(model, h: torch.Tensor, x: torch.Tensor, nbr_idx: torch.Tensor,
                              mesh: Mesh, halo: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`halo_sharded_egnn_forward_batched` of one cloud's slab [L, ·]."""
    h2, x2 = halo_sharded_egnn_forward_batched(model, h[None], x[None], nbr_idx[None], mesh,
                                               halo)
    return h2[0], x2[0]


def _check_point_step(cfg, mesh: Mesh, halo: Optional[int]) -> None:
    """ValueError where the JAX package asserts."""
    if POINT not in mesh.axes:
        raise ValueError(f"mesh axes {mesh.shape} have no {POINT!r} axis")
    if cfg.direction != "center":
        raise ValueError(f"point sharding aggregates onto local centers: direction "
                         f"'center' only (got {cfg.direction!r})")
    if cfg.use_pointnet:
        raise ValueError("the PointNet encoder is not supported point-sharded")
    d = mesh.axis_size(POINT)
    if cfg.num_nodes % d:
        raise ValueError(f"num_nodes={cfg.num_nodes} does not split over the "
                         f"{d} ranks of the point axis")
    if halo is not None and not 1 <= halo <= cfg.num_nodes // d:
        raise ValueError(f"halo={halo} must lie in [1, {cfg.num_nodes // d}] "
                         f"(num_nodes / point ranks)")


def make_point_sharded_train_step(model, optimizer, cfg, mesh: Mesh,
                                  halo: Optional[int] = None):
    """The train step with the pair batch sharded over the mesh's 'data'
    axis and every cloud's points over its 'point' axis; (state, batch) →
    (state, {loss name: this rank's data share}), the contract of `engine.make_train_step`
    (whose update it reuses: accumulation, schedule, bf16 masters). `batch`
    is this rank's block (`shard_points_batch`).

    Both clouds embed in slab mode: the all-gather regime (exact k-NN
    against the whole cloud), or with `halo` the halo regime: the cloud is
    gathered, sorted along the curve, this rank takes its slab of the
    sorted cloud, builds the ±halo graph and runs the halo EGNN, and the
    embeddings are un-sorted after the final gather. The embeddings are
    all-gathered over the point axis, and every point rank runs the head
    and `total_loss` (data-axis shares) on its rows' whole clouds.

    Gradients equal the JAX transposes (a psum over both axes): each point
    rank's objective is its data share / D_point, the final all-gather's
    backward reduce-scatters, and the step sums every gradient over the
    whole mesh. Raises ValueError where the JAX package asserts: a direction
    other than 'center', `use_pointnet`, num_nodes not dividing over the
    point axis, a halo outside [1, num_nodes / D_point]."""
    from ..train import engine
    from ..train import losses as losses_lib

    _check_point_step(cfg, mesh, halo)
    dp, i = mesh.axis_size(POINT), mesh.axis_index(POINT)

    def gather(a):
        """A slab [B, L] or [B, L, C] → the whole cloud's rows."""
        if a.dim() == 2:
            return all_gather_rows(a[..., None], mesh, POINT)[..., 0]
        return all_gather_rows(a, mesh, POINT)

    def embed(h, x):
        if halo is None:
            nbr = sharded_knn_batched(x, cfg.k, mesh)
            h2, x2 = sharded_egnn_forward_batched(model.egnn, h, x, nbr, mesh)
            return gather(h2), gather(x2)
        L = x.shape[-2]
        hs, xs, perm = morton.sort_by_curve(gather(h), gather(x), cfg.curve)
        hs, xs = hs[..., i * L:(i + 1) * L, :], xs[..., i * L:(i + 1) * L, :]
        nbr = halo_sharded_knn_batched(xs, cfg.k, mesh, halo)
        h2, x2 = halo_sharded_egnn_forward_batched(model.egnn, hs, xs, nbr, mesh, halo)
        return morton.unsort_rows((gather(h2), gather(x2)), perm)

    def loss(batch):
        h_s, x_s = embed(batch["src_feat"], batch["src_pts"])
        h_t, x_t = embed(batch["tgt_feat"], batch["tgt_pts"])
        full = {key: gather(batch[key]) for key in
                ("src_feat", "tgt_feat", "src_pts", "tgt_pts", "labels")}
        out = model.head_from_embeddings(full["src_feat"], full["tgt_feat"], full["src_pts"],
                                         full["tgt_pts"], h_s, x_s, h_t, x_t, full["labels"])
        lb = losses_lib.total_loss(out, batch["gt_pose"], full["labels"], cfg.loss_weights,
                                   mesh)
        return lb.total / dp, lb

    return engine.train_step_from_loss(model, optimizer, cfg, loss, mesh)
