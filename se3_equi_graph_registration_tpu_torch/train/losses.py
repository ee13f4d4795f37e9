"""Training losses (counterpart of `train/losses.py`): pure torch functions
over `RegistrationOutputs` and the batch.

- `correspondence_loss`: BCE with logits on the top-k scores against the
  gathered labels;
- `similarity_consistency_loss`: MSE of the standardized post- against
  pre-EGNN similarity, with torch's unbiased std;
- `egnn_equi_loss`: label-masked squared chamfer under the GT pose plus a
  cosine-feature-similarity MSE;
- `masked_point_and_feature_loss`: point and feature errors as masked means;
- `pose_loss`: geodesic rotation angle and translation-direction angle.
The 3DMatch total is corr + sim + rot + trans; KITTI weighs corr + equi.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.se3 import decompose_trans
from ..ops.numerics import safe_norm


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE with logits, meaned.

    At a logit of exactly 0 (the score MLP's output when all its ReLUs are
    dead, common at initialization) the derivative follows the reference's
    autodiff: its max(s, 0) splits the tie (½) and its |s| takes +1, which
    gives −y there rather than the smooth sigmoid(0) − y. Written so torch's
    autograd takes the same values."""
    relu = 0.5 * (logits + torch.abs(logits))                 # d/ds = ½ at 0
    magnitude = torch.where(logits >= 0, logits, -logits)    # d/ds = +1 at 0
    loss = relu - logits * targets + torch.log1p(torch.exp(-magnitude))
    return torch.mean(loss)


def correspondence_loss(scores: torch.Tensor, top_labels: torch.Tensor) -> torch.Tensor:
    return bce_with_logits(scores, top_labels)


def similarity_consistency_loss(similarity: torch.Tensor,
                                raw_similarity: torch.Tensor) -> torch.Tensor:
    """MSE between the globally standardized post- and pre-EGNN
    similarities; the std is unbiased (ddof=1), as the reference's."""
    def standardize(s):
        return (s - s.mean()) / (s.std(correction=1) + 1e-6)
    d = standardize(similarity) - standardize(raw_similarity)
    return torch.mean(d * d)


def egnn_equi_loss(h_src: torch.Tensor, x_src: torch.Tensor, h_tgt: torch.Tensor,
                   x_tgt: torch.Tensor, gt_pose: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Masked chamfer under the GT pose + cosine-similarity MSE."""
    R_gt, t_gt = decompose_trans(gt_pose)
    x_src_tf = torch.einsum("bij,bnj->bni", R_gt, x_src) + t_gt[:, None, :]
    sq = torch.sum((x_src_tf - x_tgt) ** 2, dim=-1)              # [B, N]
    rotation_loss = torch.mean(sq * labels)
    cos = torch.sum(h_src * h_tgt, dim=-1) / (safe_norm(h_src) * safe_norm(h_tgt) + 1e-8)
    feature_loss = torch.mean((cos - labels) ** 2)
    return rotation_loss + feature_loss


def masked_point_and_feature_loss(R: torch.Tensor, t: torch.Tensor, h_src: torch.Tensor,
                                  x_src: torch.Tensor, h_tgt: torch.Tensor,
                                  x_tgt: torch.Tensor, labels: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(point_error, feature_loss): the per-batch mean ‖R x_src + t − x_tgt‖
    over label-1 points, meaned over the batch; the mean feature L2 distance
    over all label-1 pairs."""
    x_tf = torch.einsum("bij,bnj->bni", R, x_src) + t[:, None, :]
    dist = safe_norm(x_tf - x_tgt)                                # [B, N]
    per_batch = torch.sum(dist * labels, dim=1) / torch.clamp(torch.sum(labels, dim=1), min=1.0)
    fdist = safe_norm(h_src - h_tgt)
    feature_loss = torch.sum(fdist * labels) / torch.clamp(torch.sum(labels), min=1.0)
    return torch.mean(per_batch), feature_loss


def _safe_arccos(cos: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """arccos clipped to (−1+eps, 1−eps): its derivative at ±1 is ∓inf, so a
    perfectly aligned pose (trace exactly 3) would otherwise give a NaN
    gradient. Worst-case angle bias √(2eps) ≈ 0.08°."""
    return torch.arccos(torch.clamp(cos, -1.0 + eps, 1.0 - eps))


def pose_loss(pred_R: torch.Tensor, pred_t: torch.Tensor, gt_pose: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(geodesic rotation angle, translation-direction angle), each [B]."""
    gt_R, gt_t = decompose_trans(gt_pose)
    M = pred_R.mT @ gt_R
    trace = M.diagonal(dim1=-2, dim2=-1).sum(-1)
    rotation_loss = _safe_arccos((trace - 1.0) / 2.0)
    dot = torch.sum(pred_t * gt_t, dim=-1)
    cos = dot / torch.clamp(safe_norm(pred_t) * safe_norm(gt_t), min=1e-8)
    return rotation_loss, _safe_arccos(cos)


class LossWeights(NamedTuple):
    corr: float = 1.0
    sim: float = 1.0
    rot: float = 1.0
    trans: float = 1.0
    equi: float = 0.0   # 3DMatch default; KITTI sets equi=1, rot=trans=0


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    corr: torch.Tensor
    sim: torch.Tensor
    rot: torch.Tensor
    trans: torch.Tensor
    equi: torch.Tensor


def total_loss(outputs, gt_pose: torch.Tensor, labels: torch.Tensor,
               weights: LossWeights = LossWeights()) -> LossBreakdown:
    """The loss families combined as the reference's training scripts do."""
    corr = correspondence_loss(outputs.scores, outputs.top_labels)
    sim = similarity_consistency_loss(outputs.similarity, outputs.raw_similarity)
    rot, trans = pose_loss(outputs.R, outputs.t, gt_pose)
    rot, trans = torch.mean(rot), torch.mean(trans)
    equi = egnn_equi_loss(outputs.h_src, outputs.x_src, outputs.h_tgt,
                          outputs.x_tgt, gt_pose, labels)
    total = (weights.corr * corr + weights.sim * sim + weights.rot * rot
             + weights.trans * trans + weights.equi * equi)
    return LossBreakdown(total=total, corr=corr, sim=sim, rot=rot, trans=trans, equi=equi)
