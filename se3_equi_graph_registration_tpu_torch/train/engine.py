"""Train and eval engine (counterpart of `train/engine.py`).

`fast_tpu_config` keeps its name so configurations carry across: a
Hilbert-sorted window k-NN graph (CUDA kernel `csrc/knn.cu`), the fused
EGNN (CUDA kernel `csrc/egcl.cu`, and in training its backward
`csrc/egcl_backward.cu`), the head, a quaternion Kabsch solve. Every
configuration runs through the kernels' wrappers, and which code runs
depends on the device alone: CPU tensors take the kernels' plain versions,
CUDA tensors launch the kernels.

The model variants route as the JAX package routes them: the fused EGCL
kernel computes the 'center' direction with the 'frame' so3 mode, with or
without the PointNet encoder in front of it; 'cluster' and 'invariant' run
the plain `models/egnn.EGNN` (the JAX package's XLA EGNN) over the
whole-cloud k-NN graph of the exact k-NN kernel. The curve-window graph
('morton') is the fused path's and refuses them.

Eval and serving may add the robust stages after the head (`robust_pose`:
spectral reweighting, IRLS, ICP single-scale or over a voxel pyramid);
`robust_eval_config` turns on spectral and IRLS on the fast config.

Training: `init_state` builds the model and Adam with the staircase
schedule, `make_train_step` returns the step (forward, losses, backward,
update, with gradient accumulation as optax.MultiSteps does), `fit` runs
epochs with best-val checkpointing (and with `profile_dir` a
`torch.profiler` trace of the first epoch). With a data-parallel `mesh`
(parallel/mesh.py) each rank trains on its rows of the global batch: the
losses are each rank's share of the global batch's, the gradients are
summed over the ranks before every Adam step, so every rank takes the full
batch's step. A mesh with a 'point' axis takes the step of
`parallel/point_sharding.make_point_sharded_train_step`, built on the same
update (`train_step_from_loss`). Metrics stay on the device and
are fetched once per epoch. `remat` recomputes the EGNN pass in the
backward instead of keeping its activations. With `bf16_params` the live
parameters are bf16 and Adam runs on fp32 masters, with stochastic
rounding back into the live ones (`utils/bf16_training.py`); every forward
computes in fp32 from the bf16 values.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Callable, Iterable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.utils.checkpoint

from ..device import resolve_device
from ..models.pose_head import RegistrationModel, RegistrationOutputs
from ..ops import morton
from ..ops.icp import icp_refine, icp_refine_multiscale, nearest_neighbor
from ..ops.kabsch import kabsch_irls, kabsch_weighted
from ..ops.kernels.egcl import KernelEGNN, egnn_forward, kernel_params
from ..ops.kernels.knn import knn_window
from ..ops.knn import gather_rows
from ..ops.numerics import fp32_matmuls
from ..ops.spectral import spectral_match_weights
from ..parallel.mesh import (Mesh, all_reduce_sum, all_reduce_sum_, barrier, broadcast_,
                             check_mesh, shard_points_batch)
from ..utils.bf16_training import Bf16SROptimizer, fp32_parameters
from . import losses as losses_lib
from . import metrics as metrics_lib
from .checkpoints import init_weights


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The JAX package's fields in its order, with the reference's defaults,
    but for three that the port reads nowhere (`train/config.py` takes them
    from a config file and drops them). 'cluster' is the direction the
    reference's checkpoints were trained in."""
    num_nodes: int = 2048
    k: int = 16
    in_node_nf: int = 32
    hidden_nf: int = 32
    n_layers: int = 3
    num_heads: int = 4
    top_k: int = 128
    lr: float = 1e-4
    lr_step: int = 200              # StepLR(step_size=200, gamma=0.5)
    lr_gamma: float = 0.5
    lr_step_unit: str = "step"      # 'step' | 'epoch' (the reference's StepLR
                                    # counts epochs; needs steps_per_epoch)
    direction: str = "center"       # 'center' | 'cluster' (the reference's
                                    # torch_cluster orientation: aggregation
                                    # onto the neighbour endpoint)
    so3_mode: str = "frame"         # 'frame' (the reference's raw frame axes)
                                    # | 'invariant' (exactly rotation-
                                    # equivariant edge features)
    loss_weights: losses_lib.LossWeights = losses_lib.LossWeights()
    remat: bool = False             # training: recompute the EGNN pass in the
                                    # backward (torch.utils.checkpoint) instead
                                    # of keeping its activations
    egnn_impl: str = "xla"          # 'xla' | 'pallas': accepted so the
                                    # reference's configs carry across; both
                                    # run the fused EGCL path
    knn_method: str = "exact"       # 'exact' | 'approx' | 'pallas' (all three
                                    # the exact whole-cloud graph) | 'morton'
    egnn_window: int = 384          # morton: curve-window width
    egnn_tile: int = 128            # morton: center tile of the graph
    curve: str = "hilbert"          # morton: 'hilbert' | 'morton'
    knn_packed: bool = False        # morton: packed int32 (d², lane) keys
    kabsch_solver: str = "svd"      # 'svd' | 'quaternion'
    egnn_accurate: bool = True      # fused EGCL: fp32, or bf16 operands
    weight_mode: str = "dot"        # train head Kabsch weights: 'dot' | 'cosine'
    fusion_literal: bool = False    # eval_fusion: reference broadcast accident
    fusion_weighting: str = "reference"  # eval_fusion: 'reference' | 'sharp'
    fusion_temp: float = 0.1
    refine_iters: int = 0           # >0: IRLS pose refinement after the head
                                    # in eval/serving (ops/kabsch.kabsch_irls)
    refine_kernel: str = "geman"    # IRLS kernel: 'geman'|'cauchy'|'huber'|...
    spectral_topm: int = 0          # >0: spectral-matching reweighting of the
                                    # head's Kabsch weights over the top-M
                                    # correspondences (ops/spectral.py)
    spectral_sigma: float = 0.09    # consistency scale (m)
    spectral_iters: int = 12        # power-iteration steps
    icp_iters: int = 0              # >0: ICP after the head (and spectral/IRLS)
                                    # in eval/serving; per scale with icp_voxels
    icp_tau: float = 0.0            # >0: hard NN-distance gate (m); 0 = MAD Welsch
    icp_mode: str = "point"         # 'point' | 'plane' | 'symmetric' | 'gicp'
    icp_trim: float = 0.0           # >0: keep that fraction of residuals; 'auto'
    icp_voxels: tuple = ()          # non-empty: coarse-to-fine ICP over this voxel
                                    # pyramid (ops/icp.icp_refine_multiscale),
                                    # ending at 0.0 (the raw clouds)
    use_pointnet: bool = False      # the PointNet encoder learns the descriptors
                                    # from the coordinates (README.md:69)
    grad_accum_steps: int = 1       # micro-batches per optimizer step
    bf16_params: bool = False       # bf16 live parameters, fp32 masters in
                                    # the optimizer, stochastic rounding
    best_val_metric: str = "loss"   # fit's best-val checkpoint criterion:
                                    # 'loss' | 'rot_err_deg' | 'trans_err_cm'


def fast_tpu_config(**overrides) -> EngineConfig:
    """The production serving config (the name is the reference's)."""
    kw = dict(egnn_impl="pallas", knn_method="morton", kabsch_solver="quaternion",
              egnn_accurate=False, knn_packed=True)
    kw.update(overrides)
    return EngineConfig(**kw)


def robust_eval_config(**overrides) -> EngineConfig:
    """The robust eval/serving stack on the fast config: 'sharp' fusion
    weighting, spectral reweighting over the top 256 correspondences, 5 IRLS
    steps. Each stage departs from the reference's parity, hence opt-in."""
    kw = dict(fusion_weighting="sharp", spectral_topm=256, refine_iters=5)
    kw.update(overrides)
    return fast_tpu_config(**kw)


def robust_pose(cfg: EngineConfig, src: torch.Tensor, tgt: torch.Tensor, R: torch.Tensor,
                t: torch.Tensor, w: torch.Tensor, icp_prior: bool
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The config's robust stages after the head, in float32 matrix products
    (`fp32_matmuls`): spectral reweighting and a weighted Kabsch solve, IRLS,
    then ICP (over `cfg.icp_voxels` when set), each where its count is > 0.
    `icp_prior` passes the weights so far to ICP as prior weights (the
    Registrar does, the eval step does not). Returns (R, t, w, the targets w
    pairs with: `tgt`, or after ICP each posed source point's nearest target
    point)."""
    cov_tgt = tgt
    with fp32_matmuls():
        if cfg.spectral_topm > 0:
            w = spectral_match_weights(src, tgt, w, top_m=cfg.spectral_topm,
                                       sigma=cfg.spectral_sigma, iters=cfg.spectral_iters)
            R, t = kabsch_weighted(src, tgt, w, solver=cfg.kabsch_solver)
        if cfg.refine_iters > 0:
            R, t, w = kabsch_irls(src, tgt, w, iters=cfg.refine_iters, kernel=cfg.refine_kernel,
                                  solver=cfg.kabsch_solver)
        if cfg.icp_iters > 0:
            kw = dict(tau=cfg.icp_tau, mode=cfg.icp_mode, trim=cfg.icp_trim,
                      solver=cfg.kabsch_solver, prior_weights=w if icp_prior else None)
            if cfg.icp_voxels:
                R, t, w = icp_refine_multiscale(src, tgt, R, t, voxel_sizes=cfg.icp_voxels,
                                                iters=cfg.icp_iters, **kw)
            else:
                R, t, w = icp_refine(src, tgt, R, t, iters=cfg.icp_iters, **kw)
            # ICP pairs by geometry: each posed source point with its nearest target
            posed = torch.einsum("bij,bnj->bni", R, src) + t[:, None, :]
            cov_tgt = gather_rows(tgt, nearest_neighbor(posed, tgt)[0])
    return R, t, w, cov_tgt


def _fused_egnn(cfg: EngineConfig) -> bool:
    """Whether the EGNN runs on the fused EGCL kernels: the 'center'
    direction with the 'frame' so3 mode, whatever the encoder and the
    parameters' dtype. 'cluster' and 'invariant' run the plain
    `models/egnn.EGNN`: the JAX package's own routing (its pose head sends
    every other mode to the XLA EGNN, not to the Pallas kernel), not a
    fallback. Their graph is still the k-NN kernel's."""
    return cfg.direction == "center" and cfg.so3_mode == "frame"


def build_model(cfg: EngineConfig, head_mode: str = "train",
                device: Union[str, torch.device, None] = None) -> RegistrationModel:
    """The model on `device` (the CUDA card unless told otherwise), in eval
    mode with torch's default initialization, its parameters fp32 (the
    optimizer casts them to bf16 with `bf16_params`). Unknown values raise
    ValueError, and so does the curve-window graph ('morton') with a model
    variant: it is the fused kernel's path, as in the JAX package."""
    if cfg.direction not in ("center", "cluster"):
        raise ValueError(f"unknown direction {cfg.direction!r}")
    if cfg.so3_mode not in ("frame", "invariant"):
        raise ValueError(f"unknown so3_mode {cfg.so3_mode!r}")
    if cfg.knn_method not in ("exact", "approx", "pallas", "morton"):
        raise ValueError(f"unknown knn_method {cfg.knn_method!r}")
    if cfg.egnn_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown egnn_impl {cfg.egnn_impl!r}")
    if cfg.knn_method == "morton" and not _fused_egnn(cfg):
        raise ValueError(
            f"knn_method='morton' runs the fused EGCL kernels, which compute "
            f"direction='center' with so3_mode='frame' (got {cfg.direction!r}, "
            f"{cfg.so3_mode!r}); use knn_method='exact' for the other modes")
    if cfg.knn_method == "morton" and cfg.use_pointnet:
        raise ValueError("knn_method='morton' bypasses the PointNet encoder stage; use "
                         "knn_method='exact' with use_pointnet")
    model = RegistrationModel(
        num_nodes=cfg.num_nodes, hidden_nf=cfg.hidden_nf, in_node_nf=cfg.in_node_nf,
        n_layers=cfg.n_layers, num_heads=cfg.num_heads, top_k=cfg.top_k,
        head_mode=head_mode, kabsch_solver=cfg.kabsch_solver,
        weight_mode=cfg.weight_mode, fusion_literal=cfg.fusion_literal,
        fusion_weighting=cfg.fusion_weighting, fusion_temp=cfg.fusion_temp,
        direction=cfg.direction, so3_mode=cfg.so3_mode, use_pointnet=cfg.use_pointnet)
    return model.to(resolve_device(device)).eval()


def _check_batch(model: RegistrationModel, batch: dict) -> None:
    dev = next(model.parameters()).device
    for key in ("src_pts", "tgt_pts", "src_feat", "tgt_feat", "labels"):
        if batch[key].device != dev:
            raise ValueError(f"batch[{key!r}] is on {batch[key].device}, the model on {dev}")


def _tile_and_window(cfg: EngineConfig, n: int) -> tuple[int, Optional[int]]:
    """(tile, window) of the k-NN kernel: the curve window for 'morton', the
    whole cloud (window None) for 'exact', 'approx' and 'pallas'."""
    if cfg.knn_method == "morton":
        if n % 128:
            raise ValueError(f"the morton path needs num_nodes divisible by 128 "
                             f"(got {n}); use knn_method='exact' for other sizes")
        return min(cfg.egnn_tile, n), min(cfg.egnn_window, n)
    return math.gcd(n, 128), None


def _forward_with_graphs(model: RegistrationModel, cfg: EngineConfig, batch: dict,
                         kp: Optional[KernelEGNN] = None) -> RegistrationOutputs:
    """k-NN graphs + model forward for a batch dict of tensors on the
    model's device. Every configuration builds its graphs with the k-NN
    wrapper: 'morton' sorts each cloud along the curve, builds the window
    graph in sorted space, runs the EGNN and un-sorts; the others search the
    whole cloud. With `use_pointnet` the encoder's descriptors replace the
    batch's features, for the EGNN and as the head's raw features. The EGNN
    runs on the fused EGCL wrapper in 'center'/'frame' (`_fused_egnn`), with
    `kp` (`kernel_params(model.egnn)`, built here when None), else the plain
    `model.egnn`. The head runs on the original order. Differentiable when
    autograd records; with `cfg.remat` the EGNN pass runs under
    `torch.utils.checkpoint` whenever autograd records. bf16 parameters
    compute in fp32 (`fp32_parameters`)."""
    _check_batch(model, batch)
    with fp32_parameters(model):
        fused = _fused_egnn(cfg)
        if fused and kp is None:
            kp = kernel_params(model.egnn)
        tile, window = _tile_and_window(cfg, batch["src_pts"].shape[1])
        packed = cfg.knn_packed and window is not None and window <= 1024

        def egnn(h, x, nbr):
            run, args = ((egnn_forward, (kp, h, x, nbr, cfg.egnn_accurate)) if fused
                         else (model.egnn, (h, x, nbr)))
            if cfg.remat and torch.is_grad_enabled():
                # the backward runs the EGNN pass (every EGCL forward launch)
                # again and keeps none of its activations; the folded weights
                # in `kp` are built outside, so their gradients flow as
                # without remat
                return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)
            return run(*args)

        def embed(h, x):
            """(the head's raw features, the EGNN's (h, x)) of one cloud."""
            raw = h
            if window is not None:
                h, x, perm = morton.sort_by_curve(h, x, cfg.curve)
            nbr = knn_window(x.contiguous(), cfg.k, tile=tile, window=window, packed=packed)
            if model.pointnet is not None:      # never with a window (build_model)
                h = raw = model.pointnet(x, nbr)
            out = egnn(h, x, nbr)
            return raw, (out if window is None else morton.unsort_rows(out, perm))

        raw_s, (h_s, x_s) = embed(batch["src_feat"], batch["src_pts"])
        raw_t, (h_t, x_t) = embed(batch["tgt_feat"], batch["tgt_pts"])
        return model.head_from_embeddings(raw_s, raw_t, batch["src_pts"], batch["tgt_pts"],
                                          h_s, x_s, h_t, x_t, batch["labels"])


@torch.no_grad()
def _apply_with_graphs(model: RegistrationModel, cfg: EngineConfig, batch: dict,
                       kp: Optional[KernelEGNN] = None) -> RegistrationOutputs:
    """The inference forward (no autograd). `kp` is
    `kernel_params(model.egnn)` when the caller keeps it."""
    return _forward_with_graphs(model, cfg, batch, kp)


def train_loss(model: RegistrationModel, cfg: EngineConfig, batch: dict,
               mesh: Optional[Mesh] = None) -> losses_lib.LossBreakdown:
    """The training forward and its losses, with autograd on the live
    parameters: the k-NN graphs, the encoder, the EGNN (on the fused path
    through `EGCLFunction`, forward and backward kernels), the train head,
    `total_loss` (with a mesh, this rank's share of the global batch's)."""
    out = _forward_with_graphs(model, cfg, batch)
    return losses_lib.total_loss(out, batch["gt_pose"], batch["labels"],
                                 cfg.loss_weights, mesh)


def lr_schedule(cfg: EngineConfig, steps_per_epoch: Optional[int] = None
                ) -> Callable[[int], float]:
    """Staircase decay init·γ^⌊step/transition⌋ over optimizer steps,
    matching the reference's StepLR(step_size, gamma). With
    lr_step_unit='epoch' the boundary converts to optimizer steps through
    `steps_per_epoch` (micro-batches per epoch; with gradient accumulation
    the optimizer advances once per `grad_accum_steps` of them)."""
    transition = cfg.lr_step
    if cfg.lr_step_unit == "epoch":
        if steps_per_epoch is None:
            raise ValueError("lr_step_unit='epoch' requires steps_per_epoch "
                             "(dataset_size // batch_size)")
        transition = max(1, cfg.lr_step * steps_per_epoch // cfg.grad_accum_steps)
    elif cfg.lr_step_unit != "step":
        raise ValueError(f"unknown lr_step_unit {cfg.lr_step_unit!r}")
    return lambda step: cfg.lr * cfg.lr_gamma ** (step // transition)


class Optimizer(NamedTuple):
    """Adam and its schedule; the schedule steps once per Adam step. With
    bf16 parameters, `sr` is the wrapper that keeps the fp32 masters and
    `adam` runs on the masters."""
    adam: torch.optim.Adam
    schedule: torch.optim.lr_scheduler.LambdaLR
    sr: Optional[Bf16SROptimizer] = None


def build_optimizer(model: RegistrationModel, cfg: EngineConfig,
                    steps_per_epoch: Optional[int] = None) -> Optimizer:
    """Adam at optax's defaults (b1 0.9, b2 0.999, eps 1e-8 added after the
    square root, no eps inside it) with the staircase schedule — the
    reference's Adam(lr) + StepLR(200, 0.5). With `bf16_params` Adam runs
    on fp32 masters copied from the model's parameters as they are here
    (the fp32 initialization), and the model's parameters then become bf16,
    rounded to nearest: the JAX `init_state` initializes its optimizer
    before that cast too."""
    make_adam = lambda ps: torch.optim.Adam(ps, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    sr = Bf16SROptimizer(model.parameters(), make_adam) if cfg.bf16_params else None
    adam = sr.inner if sr is not None else make_adam(model.parameters())
    sched = lr_schedule(cfg, steps_per_epoch)
    return Optimizer(adam, torch.optim.lr_scheduler.LambdaLR(
        adam, lambda step: sched(step) / cfg.lr), sr)


@dataclasses.dataclass
class TrainState:
    """The live training state: the model holds the parameters, the
    optimizer Adam's moments, the schedule and, with bf16 parameters, the
    fp32 masters; `step` counts micro-batches."""
    model: RegistrationModel
    optimizer: Optimizer
    step: int = 0


def init_state(cfg: EngineConfig, generator: torch.Generator,
               device: Union[str, torch.device, None] = None,
               steps_per_epoch: Optional[int] = None) -> TrainState:
    """A train-head model on `device` (the CUDA card unless told otherwise)
    with weights drawn from `generator`, and its optimizer (which makes the
    parameters bf16 with `bf16_params`)."""
    model = build_model(cfg, head_mode="train", device=device)
    init_weights(model, generator)
    return TrainState(model, build_optimizer(model, cfg, steps_per_epoch))


def make_train_step(model: RegistrationModel, optimizer: Optimizer, cfg: EngineConfig,
                    mesh: Optional[Mesh] = None) -> Callable[[TrainState, dict], tuple]:
    """(state, batch) → (state, {loss name: 0-d tensor on the device}).

    Each call is one micro-batch: the forward and backward through the
    kernels, gradients summed into `.grad` (with bf16 parameters, into the
    fp32 masters' `.grad`). Every `grad_accum_steps`-th call averages them
    (as optax.MultiSteps does), steps Adam and the schedule, and clears
    them; with bf16 parameters it then writes the stochastically rounded
    masters into the live parameters, and a micro-step between leaves both
    untouched. Nothing is fetched to the host. With a mesh, `batch` is this
    rank's rows, the losses are its shares, and the gradients are summed
    over the ranks (one all-reduce) before each Adam step. A mesh that
    shards points raises ValueError: its step is
    `parallel.point_sharding.make_point_sharded_train_step`."""
    if mesh is not None and mesh.axis_size("point") > 1:
        raise ValueError(f"a mesh of axes {mesh.shape} shards points: train with "
                         f"parallel.point_sharding.make_point_sharded_train_step")

    def loss(batch):
        lb = train_loss(model, cfg, batch, mesh)
        return lb.total, lb

    return train_step_from_loss(model, optimizer, cfg, loss, mesh)


def train_step_from_loss(model: RegistrationModel, optimizer: Optimizer, cfg: EngineConfig,
                         loss: Callable[[dict], tuple], mesh: Optional[Mesh] = None
                         ) -> Callable[[TrainState, dict], tuple]:
    """The step of `make_train_step` around `loss(batch)` → (the scalar
    this rank differentiates, the LossBreakdown it reports), which runs
    with the parameters presented in fp32 (`fp32_parameters`). With a mesh
    the gradients are summed over all of its ranks before each Adam
    step."""
    k = cfg.grad_accum_steps
    if k < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {k}")
    sr = optimizer.sr
    opt = optimizer.adam if sr is None else sr
    stepped = list(model.parameters()) if sr is None else sr.master

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        # the backward inside too: a remat pass recomputes from the fp32 views
        with fp32_parameters(model):
            objective, lb = loss(batch)
            objective.backward()
        if sr is not None:
            sr.accumulate()
        if (state.step + 1) % k == 0:
            if mesh is not None:
                all_reduce_sum_([p.grad for p in stepped if p.grad is not None], mesh)
            if k > 1:
                for p in stepped:
                    if p.grad is not None:      # Adam skips them too
                        p.grad.div_(k)
            opt.step()
            optimizer.schedule.step()
            opt.zero_grad()
        state.step += 1
        return state, {name: v.detach() for name, v in lb._asdict().items()}

    return step


def make_eval_step(model: RegistrationModel, cfg: EngineConfig, with_loss: bool = False,
                   mesh: Optional[Mesh] = None) -> Callable[[dict], dict]:
    """(batch) → per-pair RRE / RTE / recall / precision tensors, and with
    `with_loss` the batch's total training loss (broadcast per pair; with a
    mesh, the global batch's), which `fit` uses to pick the best-val
    checkpoint as the reference does. The pose goes through the config's
    robust stages (`robust_pose`, no prior weights into ICP) before the
    metrics."""

    def step(batch: dict) -> dict:
        out = _apply_with_graphs(model, cfg, batch)
        R, t, _, _ = robust_pose(cfg, batch["src_pts"], batch["tgt_pts"], out.R, out.t,
                                 out.weights, icp_prior=False)
        b = R.shape[0]
        pred = torch.eye(4, dtype=R.dtype, device=R.device).repeat(b, 1, 1)
        pred[:, :3, :3] = R
        pred[:, :3, 3] = t
        rot_err, trans_err = metrics_lib.calculate_pose_error(batch["gt_pose"], pred)
        recall, precision = metrics_lib.registration_recall(
            pred, batch["src_pts"], batch["tgt_pts"])
        m = {"rot_err_deg": rot_err, "trans_err_cm": trans_err,
             "recall": recall, "precision": precision}
        if with_loss:
            lb = losses_lib.total_loss(out, batch["gt_pose"], batch["labels"],
                                       cfg.loss_weights, mesh)
            total = lb.total if mesh is None else all_reduce_sum(lb.total, mesh)
            m["loss"] = total.expand_as(rot_err)
        return m

    return step


_BATCH_KEYS = ("labels", "src_pts", "tgt_pts", "src_feat", "tgt_feat", "gt_pose")


def batch_to_device(batch_tuple, device: Union[str, torch.device, None] = None) -> dict:
    """The reference 7-tuple (corr, labels, src_pts, tgt_pts, src_feat,
    tgt_feat, gt_pose) of numpy arrays → the engine's dict of float32
    tensors on `device` (the CUDA card unless told otherwise)."""
    dev = resolve_device(device)
    _, *arrays = batch_tuple
    return {k: torch.as_tensor(np.asarray(a, np.float32)).to(dev)
            for k, a in zip(_BATCH_KEYS, arrays)}


def _as_batch(batch, model: RegistrationModel) -> dict:
    """A reference 7-tuple or an engine dict → an engine dict on the
    model's device."""
    if isinstance(batch, tuple):
        return batch_to_device(batch, next(model.parameters()).device)
    return batch


def fit(model: RegistrationModel, optimizer: Optimizer, cfg: EngineConfig,
        state: TrainState, train_batches: Callable[[], Iterable], epochs: int,
        val_batches: Optional[Callable[[], Iterable]] = None,
        checkpointer=None, checkpoint_every: int = 20,
        logger: Optional[Callable[[int, dict], None]] = None,
        profile_dir: Optional[str] = None, mesh: Optional[Mesh] = None,
        train_step: Optional[Callable[[TrainState, dict], tuple]] = None) -> TrainState:
    """Epoch loop: per-epoch loss means (fetched once per epoch), a
    validation pass, and checkpoints through any `checkpointer` with
    `.save(step, state, metrics=...)`: the best validation score
    (`cfg.best_val_metric`, lower is better) and every `checkpoint_every`
    epochs. Batches are the reference 7-tuples or engine dicts.
    `profile_dir` runs the first epoch's training steps under
    `torch.profiler` (CPU and, with a card, CUDA activities) and writes the
    trace there as `trace.json` (chrome trace format).

    With a data-parallel `mesh`, every rank calls fit with its own rows of
    each global batch (its `PairLoader(process_shard=...)` slice; equal
    sizes on every rank). The weights (and bf16 masters) start as rank 0's,
    every step is the full batch's (`make_train_step`), the epoch's metrics
    are the global batch's and go to `logger` on every rank (as the JAX
    package's fit gives them to every process), and only rank 0 saves
    checkpoints while the others wait at a barrier.

    A mesh with a 'point' axis (the 2-axis data x point mesh) needs
    `train_step=parallel.point_sharding.make_point_sharded_train_step(...)`:
    every rank calls fit with its data rows' whole clouds, and fit cuts its
    slab of the points (`shard_points_batch`). Validation runs the unsharded
    eval step on the rank's data rows. `train_step` replaces
    `make_train_step`'s step in any case."""
    point = mesh is not None and "point" in mesh.axes
    if point and train_step is None:
        raise ValueError("a mesh with a 'point' axis needs "
                         "train_step=make_point_sharded_train_step(...)")
    if cfg.best_val_metric not in ("loss", "rot_err_deg", "trans_err_cm"):
        raise ValueError(f"unknown best_val_metric {cfg.best_val_metric!r}; expected "
                         "'loss', 'rot_err_deg' or 'trans_err_cm'")
    lead = True
    if mesh is not None:
        check_mesh(mesh, next(model.parameters()).device)
        lead = mesh.rank == 0
        broadcast_(list(model.state_dict().values())
                   + (optimizer.sr.master if optimizer.sr is not None else []), mesh)
    if train_step is None:
        train_step = make_train_step(model, optimizer, cfg, mesh)
    eval_step = make_eval_step(model, cfg, with_loss=cfg.best_val_metric == "loss", mesh=mesh)
    best_val = np.inf

    def save(*args, **kw):
        if lead:
            checkpointer.save(*args, **kw)
        barrier(mesh)

    for epoch in range(epochs):
        profiling = bool(profile_dir) and epoch == 0 and lead
        prof = contextlib.nullcontext()
        if profiling:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
        t0 = time.time()
        ms = []
        with prof:
            for batch in train_batches():
                batch = _as_batch(batch, model)
                if point:
                    batch = shard_points_batch(batch, mesh, data_axis=None)
                state, m = train_step(state, batch)
                ms.append(m)
        if profiling:
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        train_metrics = {}
        if ms:   # one stack and one fetch per epoch; with a mesh the shares' sum
            means = torch.stack([torch.stack([m[k] for m in ms]).mean() for k in ms[0]])
            if mesh is not None:
                means = all_reduce_sum(means, mesh)
            train_metrics = dict(zip(ms[0], means.tolist()))
        train_metrics["epoch_seconds"] = time.time() - t0
        if val_batches is not None:
            vals = [eval_step(_as_batch(b, model)) for b in val_batches()]
            val_metrics = {}
            if vals:   # mean of the batch means, one fetch
                means = torch.stack([torch.stack([v[k].mean() for v in vals]).mean()
                                     for k in vals[0]])
                if mesh is not None:      # each data rank's mean over its equal rows
                    means = all_reduce_sum(means, mesh) / mesh.axis_size("data")
                val_metrics = dict(zip(vals[0], means.tolist()))
            train_metrics.update({f"val_{k}": v for k, v in val_metrics.items()})
            val_score = val_metrics.get(cfg.best_val_metric, np.inf)
            if checkpointer is not None and val_score < best_val:
                best_val = val_score
                save(state.step, state, metrics={f"val_{cfg.best_val_metric}": val_score})
        if checkpointer is not None and (epoch + 1) % checkpoint_every == 0:
            save(state.step, state)
        if logger is not None:
            logger(epoch, train_metrics)
    return state


def evaluate(model: RegistrationModel, cfg: EngineConfig, batches: Iterable,
             save_path: Optional[str] = None) -> dict:
    """Test-set evaluation in the reference's report format
    (evaluation_results.txt)."""
    eval_step = make_eval_step(model, cfg)
    rows = {"rot_err_deg": [], "trans_err_cm": [], "recall": [], "precision": []}
    for batch in batches:
        m = eval_step(_as_batch(batch, model))
        for k in rows:
            rows[k].append(m[k])
    rows = {k: torch.cat(v).cpu().numpy() for k, v in rows.items()}
    summary = metrics_lib.summarize(rows["rot_err_deg"], rows["trans_err_cm"],
                                    rows["recall"], rows["precision"])
    if save_path:
        with open(save_path, "w") as f:
            f.write(f"Average Rotation Error: {summary['avg_rotation_error_deg']:.4f} degrees\n")
            f.write(f"Average Translation Error: {summary['avg_translation_error_cm']:.4f} cm\n")
            f.write(f"Average Registration Recall: {summary['avg_registration_recall']:.4f}\n")
            f.write(f"Average F1 Score: {summary['avg_f1']:.4f}\n")
    return summary

