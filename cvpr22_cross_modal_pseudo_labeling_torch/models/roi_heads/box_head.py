"""Box predictor, RoI sampling, box loss and test-time postprocessing.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/
roi_heads/box_head.py`` (``BoxPredictor`` :45, ``SampledRoIs`` :145,
``subsample_rois`` :161, ``box_head_loss`` :210, ``Detections`` :263,
``postprocess_boxes`` :270).  Both predictors: the embedding-based one,
which scores RoI embeddings against a class table passed as an argument
and regresses one class-agnostic box, and maskrcnn_benchmark's
class-specific ``FastRCNNPredictor`` (``cls_score`` over
``NUM_CLASSES``, one box per class unless ``CLS_AGNOSTIC_BBOX_REG``).
The box loss takes the baselines' per-roi sample weights and focal
reweighting; the postprocessing decodes per class and takes the
``GT_BOX_EVAL`` label override.  The ``class_valid`` mask of the JAX
predictor (class tables padded for a TPU model mesh axis) has no
counterpart.
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
from ...parallel.dist import global_sum
from ..layers import Linear
from ..rpn.rpn import top_k


class BoxPredictor(nn.Module):
    """FastRCNNPredictor on avg-pooled ``[N, 2048]`` RoI vectors.

    Embedding-based: ``emb_pred`` projects to ``emb_dim`` and the logits
    are the products with a ``[C, emb_dim]`` class table; ``bbox_pred``
    gives one class-agnostic box (background and foreground deltas, 8
    outputs).  Otherwise ``cls_score`` gives ``num_classes`` logits and
    ``bbox_pred`` ``4 * num_classes`` deltas (8 when
    ``cls_agnostic_bbox_reg``); the class table is not read."""

    def __init__(self, in_channels=2048, emb_dim=768, dtype=torch.float32, embedding_based=True,
                 num_classes=81, cls_agnostic_bbox_reg=True):
        super().__init__()
        self.embedding_based = embedding_based
        if embedding_based:
            self.emb_pred = Linear(in_channels, emb_dim, dtype=dtype)
            num_reg = 2
        else:
            self.cls_score = Linear(in_channels, num_classes, dtype=dtype)
            num_reg = 2 if cls_agnostic_bbox_reg else num_classes
        self.bbox_pred = Linear(in_channels, num_reg * 4, dtype=dtype)

    def forward(self, pooled_vec, class_embeddings=None):
        """``(logits [N, C], deltas [N, 4 * num_reg], emb [N, emb_dim]
        or None)``."""
        if not self.embedding_based:
            return self.cls_score(pooled_vec), self.bbox_pred(pooled_vec), None
        if class_embeddings is None:
            raise ValueError("the embedding-based box predictor needs a class-embedding table")
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
    cls_agnostic_bbox_reg: bool = True,
    sample_weights: Optional[torch.Tensor] = None,
    focal_gamma: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """class_logits ``[B*S, C]``, box_deltas ``[B*S, 4 * num_reg]``.

    classification = sum_i w_{y_i} s_i f_i CE_i / N_valid (``bg_weight``
    for the background; ``sample_weights`` ``[B, S]`` give s_i, else 1;
    with ``focal_gamma``, f_i = (1 - exp(-w_{y_i} CE_i))^gamma with the
    factor detached, else 1); box = sum over positives of smooth-L1
    (beta 1) on the foreground deltas / N_valid.  The foreground deltas
    are columns 4:8 when ``cls_agnostic_bbox_reg``, else the four
    columns of each roi's label (a background roi reads class 0's, which
    its zero weight masks out)."""
    labels = sampled.labels.reshape(-1)
    valid = sampled.valid.reshape(-1)
    is_pos = sampled.is_pos.reshape(-1)
    reg_targets = sampled.reg_targets.reshape(-1, 4)
    n = global_sum(valid.to(torch.float32).sum()).clamp(min=1.0)

    logp = F.log_softmax(class_logits, dim=-1)
    ce = -torch.gather(logp, 1, labels.clamp(min=0)[:, None])[:, 0]
    class_w = torch.where(labels == 0, bg_weight, 1.0)
    w = class_w * valid.to(ce.dtype)
    if focal_gamma is not None:
        w = w * (1.0 - torch.exp(-(ce * class_w).detach())) ** focal_gamma
    if sample_weights is not None:
        w = w * sample_weights.reshape(-1)
    classification_loss = torch.sum(ce * w) / n

    if cls_agnostic_bbox_reg:
        pos_deltas = box_deltas[:, 4:8]
    else:
        cols = 4 * labels.clamp(min=0)[:, None] + torch.arange(4, device=labels.device)[None, :]
        pos_deltas = torch.gather(box_deltas, 1, cols)
    box_l = smooth_l1_loss(pos_deltas, reg_targets, beta=1.0)
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
    cls_agnostic_bbox_reg: bool = True,
    gt_override_labels: Optional[torch.Tensor] = None,
) -> Detections:
    """Softmax, decode (one box, or one per class), the top
    ``pre_nms_candidates`` (roi, class >= 1) pairs by score above
    ``score_thresh``, then one per-class NMS pass keeping
    ``detections_per_img``; batched over images.

    class_logits ``[B, S, C]``; box_deltas ``[B, S, 4 * num_reg]`` (the
    last 4 are the foreground box when class-agnostic, else class c's
    box is columns 4c:4c+4); proposals ``[B, S, 4]``; proposal_valid
    ``[B, S]``.  ``gt_override_labels`` ``[B, S]`` (``GT_BOX_EVAL``; -1
    for none): in an image with any override, each roi keeps only its
    own label's probability plus 1.1 and every other score is 0."""
    b, s, num_classes = class_logits.shape
    probs = torch.softmax(class_logits, dim=-1)
    if gt_override_labels is not None:
        active = gt_override_labels >= 0
        onehot = F.one_hot(gt_override_labels.clamp(min=0).to(torch.int64), num_classes).to(probs.dtype)
        onehot = onehot * active[..., None]
        probs = torch.where(active.any(dim=1)[:, None, None], onehot * (probs + 1.1), probs)
    if cls_agnostic_bbox_reg:
        boxes = clip_to_image(decode_boxes(box_deltas[..., -4:], proposals, reg_weights), image_sizes)
    else:
        boxes = decode_boxes(box_deltas, proposals, reg_weights).reshape(b, s, num_classes, 4)
        boxes = clip_to_image(boxes, image_sizes[:, None])

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
    if cls_agnostic_bbox_reg:
        top_boxes = boxes[bi, roi_idx]
    else:
        top_boxes = boxes[bi, roi_idx, cls_idx]
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
