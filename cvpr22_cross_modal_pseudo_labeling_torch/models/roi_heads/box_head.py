"""Box predictor, RoI sampling, box loss and test-time postprocessing.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/
roi_heads/box_head.py`` (``BoxPredictor`` :45, ``SampledRoIs`` :145,
``subsample_rois`` :161, ``box_head_loss`` :210, ``Detections`` :263,
``postprocess_boxes`` :270) for the configuration the port runs: the
embedding-based predictor, which scores RoI embeddings against a class
table passed as an argument, with class-agnostic box regression.  The
``class_valid`` mask of the JAX predictor (class tables padded for a TPU
model mesh axis) has no counterpart, nor have the baselines' per-sample
weights and focal reweighting of the box loss.
"""

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.box_coder import decode_boxes, encode_boxes
from ...core.boxes import box_iou, clip_to_image
from ...core.matcher import match_boxes
from ...core.sampler import balanced_sample_indices, draw_priorities
from ...ops.losses import smooth_l1_loss
from ...ops.nms import batched_nms
from ..layers import Linear
from ..rpn.rpn import top_k


class BoxPredictor(nn.Module):
    """The embedding-based FastRCNNPredictor on avg-pooled ``[N, 2048]``
    RoI vectors: logits against a ``[C, emb_dim]`` class table, and one
    class-agnostic box (background + foreground deltas, 8 outputs)."""

    def __init__(self, in_channels=2048, emb_dim=768, dtype=torch.float32):
        super().__init__()
        self.emb_pred = Linear(in_channels, emb_dim, dtype=dtype)
        self.bbox_pred = Linear(in_channels, 2 * 4, dtype=dtype)

    def forward(self, pooled_vec, class_embeddings):
        emb = self.emb_pred(pooled_vec)
        logits = emb @ class_embeddings.to(emb.dtype).T
        return logits, self.bbox_pred(pooled_vec), emb


class SampledRoIs(NamedTuple):
    boxes: torch.Tensor  # [B, S, 4]
    labels: torch.Tensor  # [B, S] int64 (0 = background)
    reg_targets: torch.Tensor  # [B, S, 4]
    valid: torch.Tensor  # [B, S] bool
    is_pos: torch.Tensor  # [B, S] bool
    matched_gt: torch.Tensor  # [B, S] int64 index into the gt

    def head(self, cap: int) -> "SampledRoIs":
        """The first ``cap`` slots per image: sampling puts positives
        first, so this keeps every positive whenever #pos <= cap (the
        reference computes masks on positives only)."""
        return SampledRoIs(*(a[:, :cap] for a in self))


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a [B, N, ...]`` at ``idx [B, S]`` along axis 1."""
    idx = idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(idx.shape + a.shape[2:])
    return torch.gather(a, 1, idx)


def subsample_rois(
    proposals: torch.Tensor,
    proposal_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    rand: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    batch_size_per_image: int = 512,
    positive_fraction: float = 0.25,
    fg_iou_threshold: float = 0.5,
    bg_iou_threshold: float = 0.5,
    reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0),
) -> SampledRoIs:
    """Positive/negative RoI sampling, batched over images.

    proposals ``[B, N, 4]``; gt ``[B, G, ...]``.  ``rand`` ``[B, 2, N]``
    holds the sampler's priorities (see ``core/sampler.py``); without it
    they are drawn from ``generator``."""
    b, n = proposals.shape[:2]
    if rand is None:
        rand = draw_priorities(b, n, proposals.device, generator)
    quality = box_iou(gt_boxes, proposals)  # [B, G, N]
    matched = match_boxes(quality, gt_valid, fg_iou_threshold, bg_iou_threshold)
    pos = (matched >= 0) & proposal_valid
    neg = (matched == -1) & proposal_valid
    idx, valid, is_pos = balanced_sample_indices(
        pos, neg, rand, batch_size_per_image, positive_fraction
    )
    sampled_boxes = _take(proposals, idx)
    sampled_matched = torch.gather(matched, 1, idx).clamp(min=0)
    labels = torch.where(is_pos, torch.gather(gt_labels.to(torch.int64), 1, sampled_matched), 0)
    reg_targets = encode_boxes(_take(gt_boxes, sampled_matched), sampled_boxes, reg_weights)
    return SampledRoIs(sampled_boxes, labels, reg_targets, valid, is_pos, sampled_matched)


def box_head_loss(
    class_logits: torch.Tensor,
    box_deltas: torch.Tensor,
    sampled: SampledRoIs,
    bg_weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """class_logits ``[B*S, C]``, box_deltas ``[B*S, 8]`` (class-agnostic).

    classification = sum_i w_{y_i} CE_i / N_valid (``bg_weight`` for the
    background); box = sum over positives of smooth-L1 (beta 1) on the
    foreground deltas / N_valid."""
    labels = sampled.labels.reshape(-1)
    valid = sampled.valid.reshape(-1)
    is_pos = sampled.is_pos.reshape(-1)
    reg_targets = sampled.reg_targets.reshape(-1, 4)
    n = valid.to(torch.float32).sum().clamp(min=1.0)

    logp = F.log_softmax(class_logits, dim=-1)
    ce = -torch.gather(logp, 1, labels.clamp(min=0)[:, None])[:, 0]
    class_w = torch.where(labels == 0, bg_weight, 1.0)
    w = class_w * valid.to(ce.dtype)
    classification_loss = torch.sum(ce * w) / n

    box_l = smooth_l1_loss(box_deltas[:, 4:8], reg_targets, beta=1.0)
    box_loss = torch.sum(box_l * is_pos.to(box_l.dtype)[:, None]) / n
    return classification_loss, box_loss


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, D, 4]
    scores: torch.Tensor  # [B, D]
    labels: torch.Tensor  # [B, D] int32
    valid: torch.Tensor  # [B, D] bool


def postprocess_boxes(
    class_logits: torch.Tensor,
    box_deltas: torch.Tensor,
    proposals: torch.Tensor,
    proposal_valid: torch.Tensor,
    image_sizes: torch.Tensor,
    score_thresh: float = 0.05,
    nms_thresh: float = 0.5,
    detections_per_img: int = 100,
    pre_nms_candidates: int = 1000,
    reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0),
) -> Detections:
    """Softmax, class-agnostic decode, the top ``pre_nms_candidates``
    (roi, class >= 1) pairs by score above ``score_thresh``, then one
    per-class NMS pass keeping ``detections_per_img``; batched over
    images.

    class_logits ``[B, S, C]``; box_deltas ``[B, S, 8]`` (the last 4 are
    the foreground box); proposals ``[B, S, 4]``; proposal_valid
    ``[B, S]``."""
    b, s, num_classes = class_logits.shape
    probs = torch.softmax(class_logits, dim=-1)
    boxes = decode_boxes(box_deltas[..., -4:], proposals, reg_weights)
    boxes = clip_to_image(boxes, image_sizes)

    cand_scores = probs[..., 1:]
    cand_valid = (cand_scores > score_thresh) & proposal_valid[..., None]
    flat_scores = torch.where(
        cand_valid, cand_scores, torch.full((), -1.0, device=cand_scores.device)
    ).reshape(b, -1)
    k = min(pre_nms_candidates, flat_scores.shape[1])
    top_scores, top_idx = top_k(flat_scores, k)
    roi_idx = top_idx // (num_classes - 1)
    cls_idx = top_idx % (num_classes - 1) + 1
    bi = torch.arange(b, device=top_idx.device)[:, None]
    top_boxes = boxes[bi, roi_idx]
    top_valid = top_scores > score_thresh

    keep_idx, keep_valid = batched_nms(
        top_boxes, top_scores, cls_idx, top_valid, nms_thresh, detections_per_img
    )
    keep_idx = keep_idx.to(torch.int64)
    return Detections(
        boxes=top_boxes[bi, keep_idx],
        scores=torch.gather(top_scores, 1, keep_idx),
        labels=torch.gather(cls_idx, 1, keep_idx).to(torch.int32),
        valid=keep_valid,
    )
