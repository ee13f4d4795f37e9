"""Inference engine (counterpart of `train/engine.py`, inference only).

`fast_tpu_config` keeps its name so configurations carry across: a
Hilbert-sorted window k-NN graph (CUDA kernel `csrc/knn.cu`), the fused
EGNN (CUDA kernel `csrc/egcl.cu`), the head, a quaternion Kabsch solve.
Every configuration runs through both kernels' wrappers, and which code runs
depends on the device alone: CPU tensors take the kernels' plain versions,
CUDA tensors launch the kernels. `models/egnn.EGNN` is the readable
reference the tests hold the fused path to; the engine does not call it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import torch

from ..device import resolve_device
from ..models.pose_head import RegistrationModel, RegistrationOutputs
from ..ops import morton
from ..ops.kernels.egcl import KernelEGNN, egnn_forward, kernel_params
from ..ops.kernels.knn import knn_window
from . import metrics as metrics_lib


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The fields the inference path reads, with the reference's defaults.
    The model is always 'center'/'frame'; head top-k is always exact (the
    reference's approx top-k returns the exact sets on the CPU)."""
    num_nodes: int = 2048
    k: int = 16
    in_node_nf: int = 32
    hidden_nf: int = 32
    n_layers: int = 3
    num_heads: int = 4
    top_k: int = 128
    egnn_impl: str = "xla"          # 'xla' | 'pallas': accepted so the
                                    # reference's configs carry across; both
                                    # run the fused EGCL path
    knn_method: str = "exact"       # 'exact' | 'approx' (= exact) | 'morton'
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


def fast_tpu_config(**overrides) -> EngineConfig:
    """The production serving config (the name is the reference's)."""
    kw = dict(egnn_impl="pallas", knn_method="morton", kabsch_solver="quaternion",
              egnn_accurate=False, knn_packed=True)
    kw.update(overrides)
    return EngineConfig(**kw)


def build_model(cfg: EngineConfig, head_mode: str = "train",
                device: Union[str, torch.device, None] = None) -> RegistrationModel:
    """The model on `device` (the CUDA card unless told otherwise), in eval
    mode with torch's default initialization."""
    if cfg.knn_method not in ("exact", "approx", "morton"):
        raise ValueError(f"unknown knn_method {cfg.knn_method!r}")
    if cfg.egnn_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown egnn_impl {cfg.egnn_impl!r}")
    model = RegistrationModel(
        num_nodes=cfg.num_nodes, hidden_nf=cfg.hidden_nf, in_node_nf=cfg.in_node_nf,
        n_layers=cfg.n_layers, num_heads=cfg.num_heads, top_k=cfg.top_k,
        head_mode=head_mode, kabsch_solver=cfg.kabsch_solver,
        weight_mode=cfg.weight_mode, fusion_literal=cfg.fusion_literal,
        fusion_weighting=cfg.fusion_weighting, fusion_temp=cfg.fusion_temp)
    return model.to(resolve_device(device)).eval()


def _check_batch(model: RegistrationModel, batch: dict) -> None:
    dev = next(model.parameters()).device
    for key in ("src_pts", "tgt_pts", "src_feat", "tgt_feat", "labels"):
        if batch[key].device != dev:
            raise ValueError(f"batch[{key!r}] is on {batch[key].device}, the model on {dev}")


def _tile_and_window(cfg: EngineConfig, n: int) -> tuple[int, Optional[int]]:
    """(tile, window) of the k-NN kernel: the curve window for 'morton', the
    whole cloud (window None) for 'exact'/'approx'."""
    if cfg.knn_method == "morton":
        if n % 128:
            raise ValueError(f"the morton path needs num_nodes divisible by 128 "
                             f"(got {n}); use knn_method='exact' for other sizes")
        return min(cfg.egnn_tile, n), min(cfg.egnn_window, n)
    return math.gcd(n, 128), None


@torch.no_grad()
def _apply_with_graphs(model: RegistrationModel, cfg: EngineConfig, batch: dict,
                       kp: Optional[KernelEGNN] = None) -> RegistrationOutputs:
    """k-NN graphs + model forward for a batch dict of tensors on the
    model's device. Every configuration goes through the k-NN and EGCL
    wrappers: 'morton' sorts each cloud along the curve, builds the window
    graph in sorted space, runs the EGNN and un-sorts; 'exact'/'approx'
    search the whole cloud. `kp` is `kernel_params(model.egnn)` when the
    caller keeps it; the head runs on the original order."""
    _check_batch(model, batch)
    kp = kernel_params(model.egnn) if kp is None else kp
    tile, window = _tile_and_window(cfg, batch["src_pts"].shape[1])
    packed = cfg.knn_packed and window is not None and window <= 1024

    def embed(h, x):
        if window is not None:
            h, x, perm = morton.sort_by_curve(h, x, cfg.curve)
        nbr = knn_window(x.contiguous(), cfg.k, tile=tile, window=window, packed=packed)
        out = egnn_forward(kp, h, x, nbr, accurate=cfg.egnn_accurate)
        return out if window is None else morton.unsort_rows(out, perm)

    h_s, x_s = embed(batch["src_feat"], batch["src_pts"])
    h_t, x_t = embed(batch["tgt_feat"], batch["tgt_pts"])
    return model.head_from_embeddings(
        batch["src_feat"], batch["tgt_feat"], batch["src_pts"], batch["tgt_pts"],
        h_s, x_s, h_t, x_t, batch["labels"])


def make_eval_step(model: RegistrationModel, cfg: EngineConfig
                   ) -> Callable[[dict], dict]:
    """(batch) → per-pair RRE / RTE / recall / precision tensors."""

    def step(batch: dict) -> dict:
        out = _apply_with_graphs(model, cfg, batch)
        b = out.R.shape[0]
        pred = torch.eye(4, dtype=out.R.dtype, device=out.R.device).repeat(b, 1, 1)
        pred[:, :3, :3] = out.R
        pred[:, :3, 3] = out.t
        rot_err, trans_err = metrics_lib.calculate_pose_error(batch["gt_pose"], pred)
        recall, precision = metrics_lib.registration_recall(
            pred, batch["src_pts"], batch["tgt_pts"])
        return {"rot_err_deg": rot_err, "trans_err_cm": trans_err,
                "recall": recall, "precision": precision}

    return step

