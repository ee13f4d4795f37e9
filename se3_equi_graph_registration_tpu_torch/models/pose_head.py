"""Pose-regression model: shared EGNN over both clouds, correspondence
scoring and the weighted-Kabsch solve (counterpart of `models/pose_head.py`).

Two heads:
- 'train': top-k by post-EGNN similarity, ScoreMLP logits, Kabsch with
  masked-softmax weights over post-EGNN coordinates;
- 'eval_fusion': top-k by pre-EGNN similarity, ScoreMLP logits fused into
  the raw similarities, scattered back over N, then weighted Kabsch over
  the original coordinates.
Head top-k is `torch.topk`; 'approx' maps to exact (sets, not order, matter
downstream).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.kabsch import kabsch_weighted, masked_softmax
from .egnn import EGNN


class RegistrationOutputs(NamedTuple):
    R: torch.Tensor               # [B, 3, 3]
    t: torch.Tensor               # [B, 3]
    scores: torch.Tensor          # [B, top_k] correspondence logits
    top_labels: torch.Tensor      # [B, top_k]
    top_indices: torch.Tensor     # [B, top_k]
    similarity: torch.Tensor      # [B, N] post-EGNN feature similarity
    raw_similarity: torch.Tensor  # [B, N] pre-EGNN feature similarity
    h_src: torch.Tensor
    x_src: torch.Tensor
    h_tgt: torch.Tensor
    x_tgt: torch.Tensor
    weights: torch.Tensor         # [B, N] Kabsch weights


def fuse_scores(pred_scores: torch.Tensor, raw_topk: torch.Tensor,
                literal: bool = False) -> torch.Tensor:
    """Where the score MLP is confident (pred > 0.5) and beats the raw
    similarity (|pred − 1| < raw or pred < raw), its logit replaces it.
    literal=True replays the reference's broadcast accident (slot 0's
    score everywhere)."""
    if literal:
        pred_scores = pred_scores[..., :1].expand_as(pred_scores)
    confident = pred_scores > 0.5
    take = confident & ((torch.abs(pred_scores - 1.0) < raw_topk)
                        | (pred_scores < raw_topk))
    return torch.where(take, pred_scores, raw_topk)


def _batched_gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values [B, N, C] or [B, N] at idx [B, K] → [B, K, C] / [B, K]."""
    if values.dim() == 2:
        return torch.take_along_dim(values, idx, dim=1)
    return torch.take_along_dim(values, idx[..., None], dim=1)


class ScoreMLP(nn.Module):
    """Correspondence-score MLP 2H → H → H/2 → 1."""

    def __init__(self, hidden_nf: int):
        super().__init__()
        self.dense_0 = nn.Linear(2 * hidden_nf, hidden_nf)
        self.dense_1 = nn.Linear(hidden_nf, hidden_nf // 2)
        self.dense_2 = nn.Linear(hidden_nf // 2, 1)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.dense_0(feats))
        y = F.relu(self.dense_1(y))
        return self.dense_2(y)[..., 0]


class RegistrationModel(nn.Module):
    """End-to-end correspondence-graph registration model ('center'/'frame')."""

    def __init__(self, num_nodes: int = 2048, hidden_nf: int = 32,
                 in_node_nf: int = 32, n_layers: int = 3, num_heads: int = 4,
                 top_k: int = 128, head_mode: str = "train",
                 kabsch_solver: str = "svd", weight_mode: str = "dot",
                 fusion_literal: bool = False,
                 fusion_weighting: str = "reference", fusion_temp: float = 0.1):
        super().__init__()
        if head_mode not in ("train", "eval_fusion"):
            raise ValueError(f"unknown head_mode {head_mode!r}")
        self.num_nodes, self.hidden_nf, self.in_node_nf = num_nodes, hidden_nf, in_node_nf
        self.n_layers, self.num_heads, self.top_k = n_layers, num_heads, top_k
        self.head_mode, self.kabsch_solver = head_mode, kabsch_solver
        self.weight_mode, self.fusion_literal = weight_mode, fusion_literal
        self.fusion_weighting, self.fusion_temp = fusion_weighting, fusion_temp
        self.egnn = EGNN(in_node_nf=in_node_nf, hidden_nf=hidden_nf,
                         out_node_nf=hidden_nf, n_layers=n_layers,
                         num_heads=num_heads)
        self.mlp = ScoreMLP(hidden_nf)

    def forward(self, h_src, x_src, nbr_src, h_tgt, x_tgt, nbr_tgt,
                labels) -> RegistrationOutputs:
        """The plain path: both clouds through the plain EGNN module."""
        e_src = self.egnn(h_src, x_src, nbr_src)
        e_tgt = self.egnn(h_tgt, x_tgt, nbr_tgt)
        return self.head_from_embeddings(h_src, h_tgt, x_src, x_tgt,
                                         *e_src, *e_tgt, labels)

    def head_from_embeddings(self, raw_h_src, raw_h_tgt, raw_x_src, raw_x_tgt,
                             h_src, x_src, h_tgt, x_tgt,
                             labels) -> RegistrationOutputs:
        """Scoring + weighted Kabsch from (raw, embedded) features."""
        similarity = torch.sum(h_src * h_tgt, dim=-1)
        raw_similarity = torch.sum(raw_h_src * raw_h_tgt, dim=-1)
        if self.head_mode == "eval_fusion":
            return self._eval_head(raw_similarity, similarity, h_src, x_src,
                                   h_tgt, x_tgt, raw_x_src, raw_x_tgt, labels)
        top_idx = self._top_k(similarity)
        scores = self.mlp(torch.cat([_batched_gather(h_src, top_idx),
                                     _batched_gather(h_tgt, top_idx)], dim=-1))
        if self.weight_mode == "cosine":
            ns = torch.linalg.norm(h_src, dim=-1, keepdim=True) + 1e-6
            nt = torch.linalg.norm(h_tgt, dim=-1, keepdim=True) + 1e-6
            weight_scores = torch.sum((h_src / ns) * (h_tgt / nt), dim=-1)
        elif self.weight_mode == "dot":
            weight_scores = similarity
        else:
            raise ValueError(f"unknown weight_mode {self.weight_mode!r}")
        weights = masked_softmax(weight_scores, labels)
        R, t = kabsch_weighted(x_src, x_tgt, weights, solver=self.kabsch_solver)
        return RegistrationOutputs(
            R=R, t=t, scores=scores, top_labels=_batched_gather(labels, top_idx),
            top_indices=top_idx, similarity=similarity,
            raw_similarity=raw_similarity, h_src=h_src, x_src=x_src,
            h_tgt=h_tgt, x_tgt=x_tgt, weights=weights)

    def _top_k(self, scores: torch.Tensor) -> torch.Tensor:
        if (self.top_k == scores.shape[-1]
                and not (self.head_mode == "eval_fusion" and self.fusion_literal)):
            # k == N selects everything; consumers are permutation-invariant
            return torch.arange(self.top_k, device=scores.device).expand_as(scores)
        return torch.topk(scores, self.top_k, dim=-1).indices

    def _eval_head(self, raw_similarity, similarity, h_src, x_src, h_tgt, x_tgt,
                   raw_x_src, raw_x_tgt, labels) -> RegistrationOutputs:
        top_idx = self._top_k(raw_similarity)
        pred_scores = self.mlp(torch.cat([_batched_gather(h_src, top_idx),
                                          _batched_gather(h_tgt, top_idx)], dim=-1))
        raw_topk = _batched_gather(raw_similarity, top_idx)
        fused_topk = fuse_scores(pred_scores, raw_topk, literal=self.fusion_literal)
        fused = raw_similarity.scatter(1, top_idx, fused_topk.to(raw_similarity.dtype))
        if self.fusion_weighting == "sharp":
            weights = torch.softmax(fused / self.fusion_temp, dim=-1)
        elif self.fusion_weighting == "reference":
            fused = fused / (torch.sum(fused, dim=-1, keepdim=True) + 1e-6)
            weights = torch.softmax(fused, dim=-1)
        else:
            raise ValueError(f"unknown fusion_weighting {self.fusion_weighting!r}")
        R, t = kabsch_weighted(raw_x_src, raw_x_tgt, weights, solver=self.kabsch_solver)
        return RegistrationOutputs(
            R=R, t=t, scores=pred_scores,
            top_labels=_batched_gather(labels, top_idx), top_indices=top_idx,
            similarity=similarity, raw_similarity=raw_similarity,
            h_src=h_src, x_src=x_src, h_tgt=h_tgt, x_tgt=x_tgt, weights=weights)
