"""Region Proposal Network head, proposal selection and loss.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/rpn/
rpn.py`` (``RPNHead`` :28, ``flatten_rpn_outputs`` :61,
``select_proposals_single_level`` :76, ``select_proposals_multi_level``
:116, ``rpn_loss`` :229).
"""

import logging
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.box_coder import decode_boxes, encode_boxes
from ...core.boxes import box_iou, clip_to_image, nonempty_mask
from ...core.matcher import match_boxes
from ...core.sampler import balanced_sample_masks, draw_priorities
from ...ops.losses import binary_cross_entropy_with_logits, smooth_l1_loss
from ...ops.nms import nms
from ...parallel.dist import global_sum
from ..layers import Conv2d


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness / 1x1 box heads per level.  The
    conv puts out ``in_channels`` from ``input_channels`` (default
    ``in_channels``): they differ on the C5 body, whose trunk is wider
    than its statics' ``BACKBONE_OUT_CHANNELS`` (flax infers the input
    width)."""

    def __init__(self, in_channels: int, num_anchors: int, dtype=torch.float32, input_channels: int = None):
        super().__init__()
        cin = in_channels if input_channels is None else input_channels
        self.conv = Conv2d(cin, in_channels, 3, padding=1, dtype=dtype)
        self.cls_logits = Conv2d(in_channels, num_anchors, 1, dtype=dtype)
        self.bbox_pred = Conv2d(in_channels, num_anchors * 4, 1, dtype=dtype)

    def forward(self, features: Sequence[torch.Tensor]):
        """``[B, H, W, C]`` per level -> objectness ``[B, H, W, A]`` and
        box regression ``[B, H, W, 4A]`` per level."""
        objectness, box_reg = [], []
        for f in features:
            t = F.relu(self.conv(f.permute(0, 3, 1, 2)))
            objectness.append(self.cls_logits(t).permute(0, 2, 3, 1))
            box_reg.append(self.bbox_pred(t).permute(0, 2, 3, 1))
        return objectness, box_reg


def flatten_rpn_outputs(objectness, box_regression):
    """Per-level ``[B,H,W,A]`` / ``[B,H,W,4A]`` -> ``[B, N]`` /
    ``[B, N, 4]`` in (level, y, x, a) order, the anchors' order."""
    b = objectness[0].shape[0]
    objs = [o.reshape(b, -1) for o in objectness]
    regs = [r.reshape(b, -1, 4) for r in box_regression]
    return torch.cat(objs, dim=1), torch.cat(regs, dim=1)


class RPNProposals(NamedTuple):
    boxes: torch.Tensor  # [B, P, 4]
    scores: torch.Tensor  # [B, P] sigmoid objectness
    valid: torch.Tensor  # [B, P] bool


_ORDER_INTS = {2: (torch.int16, 0x7FFF), 4: (torch.int32, 0x7FFFFFFF), 8: (torch.int64, 0x7FFFFFFFFFFFFFFF)}


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: descending, ties broken by
    the lower index (``torch.topk`` promises no tie order).  The stable
    sort runs on the floats' bits with a negative's non-sign bits
    flipped, an integer key in the floats' total order, so that -0.0
    sorts below 0.0 as in ``lax.top_k`` (a float sort ties them)."""
    itype, low = _ORDER_INTS[x.element_size()]
    bits = x.contiguous().view(itype)
    key = bits ^ ((bits >> (8 * x.element_size() - 1)) & low)
    indices = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(x, -1, indices), indices


def select_proposals_single_level(
    anchors: torch.Tensor,
    objectness: torch.Tensor,
    box_regression: torch.Tensor,
    image_sizes: torch.Tensor,
    pre_nms_top_n: int,
    post_nms_top_n: int,
    nms_thresh: float,
    min_size: float,
) -> RPNProposals:
    """Top-k by objectness, decode, clip, min-size filter, NMS, per image
    (all images in one batched pass).  The proposals carry no gradient:
    the JAX function stops it at its outputs (rpn.py:110-113); the port
    cuts it at the inputs, so that no graph is built for the selection.

    anchors ``[N, 4]``; objectness ``[B, N]`` raw logits; box_regression
    ``[B, N, 4]``; image_sizes ``[B, 2]`` (h, w)."""
    objectness = objectness.detach()
    box_regression = box_regression.detach()
    n = anchors.shape[0]
    k = min(pre_nms_top_n, n)
    topv, topi = top_k(objectness, k)
    sel_anchors = anchors[topi]
    sel_reg = torch.gather(box_regression, 1, topi[..., None].expand(-1, -1, 4))
    boxes = decode_boxes(sel_reg, sel_anchors, (1.0, 1.0, 1.0, 1.0))
    boxes = clip_to_image(boxes, image_sizes)
    keep = nonempty_mask(boxes, min_size)
    scores = torch.sigmoid(topv)
    idx, keep_valid = nms(boxes, scores, keep, nms_thresh, post_nms_top_n)
    idx = idx.to(torch.int64)
    return RPNProposals(
        boxes=torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
        scores=torch.gather(scores, 1, idx),
        valid=keep_valid,
    )


def select_proposals_multi_level(
    anchor_list: List[torch.Tensor],
    objectness: torch.Tensor,
    box_regression: torch.Tensor,
    image_sizes: torch.Tensor,
    pre_nms_top_n: int,
    post_nms_top_n: int,
    nms_thresh: float,
    min_size: float,
    fpn_post_nms_top_n: int = 0,
    fpn_post_nms_per_batch: bool = False,
    per_batch_groups: int = 1,
) -> RPNProposals:
    """Proposal selection over any number of levels.  One level is
    :func:`select_proposals_single_level`.  Several (FPN): each level's
    top-k, decode, NMS and ``post_nms_top_n``, then the top
    ``fpn_post_nms_top_n`` (else ``post_nms_top_n``) by objectness over
    the concatenated levels, invalid slots keyed ``-inf``.

    ``fpn_post_nms_per_batch`` (training) keeps JAX's per-batch quirk:
    the top-N runs over the whole batch's concatenated scores, in
    ``per_batch_groups`` contiguous groups of images (the gcd of the
    batch and the group count when they do not divide), as a scatter
    mask that keeps the padded per-image layout; a slot the mask cuts
    is invalid.  Every top-k is the stable :func:`top_k` of
    ``lax.top_k``: the ``-inf`` keys tie in bulk.

    ``anchor_list`` holds each level's ``[N_l, 4]`` anchors in the order
    of ``objectness`` ``[B, sum N_l]`` and ``box_regression``."""
    if len(anchor_list) == 1:
        return select_proposals_single_level(
            anchor_list[0], objectness, box_regression, image_sizes,
            pre_nms_top_n, post_nms_top_n, nms_thresh, min_size,
        )
    parts = []
    offset = 0
    for anchors in anchor_list:
        n = anchors.shape[0]
        parts.append(select_proposals_single_level(
            anchors, objectness[:, offset:offset + n], box_regression[:, offset:offset + n],
            image_sizes, pre_nms_top_n, post_nms_top_n, nms_thresh, min_size,
        ))
        offset += n
    boxes = torch.cat([p.boxes for p in parts], dim=1)
    scores = torch.cat([p.scores for p in parts], dim=1)
    valid = torch.cat([p.valid for p in parts], dim=1)
    neg_inf = torch.full((), -float("inf"), device=scores.device)
    keyed = torch.where(valid, scores, neg_inf)
    fpn_top_n = fpn_post_nms_top_n or post_nms_top_n
    k = min(fpn_top_n, boxes.shape[1])
    if fpn_post_nms_per_batch:
        b, p = keyed.shape
        groups = max(per_batch_groups, 1)
        g = math.gcd(b, groups)
        if g != groups:
            logging.getLogger(__name__).warning(
                "FPN_POST_NMS_PER_BATCH: batch %d not divisible by %d groups; "
                "falling back to gcd grouping g=%d", b, per_batch_groups, g,
            )
        flat = keyed.reshape(g, (b // g) * p)
        _, flat_idx = top_k(flat, min(fpn_top_n, flat.shape[1]))
        keep = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
        keep.scatter_(1, flat_idx, True)
        keyed = torch.where(keep.reshape(b, p), keyed, neg_inf)
    top, idx = top_k(keyed, k)
    out_valid = torch.gather(valid, 1, idx)
    if fpn_post_nms_per_batch:
        out_valid = out_valid & (top > -float("inf"))
    return RPNProposals(
        torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
        torch.gather(scores, 1, idx),
        out_valid,
    )


def rpn_loss(
    anchors: torch.Tensor,
    visibility: torch.Tensor,
    objectness: torch.Tensor,
    box_regression: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    rand: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    fg_iou_threshold: float = 0.7,
    bg_iou_threshold: float = 0.3,
    batch_size_per_image: int = 256,
    positive_fraction: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RPN losses, batched over images: (objectness, box) scalars.

    anchors ``[N, 4]``; visibility, objectness ``[B, N]``; box_regression
    ``[B, N, 4]``; gt_boxes ``[B, G, 4]``; gt_valid ``[B, G]``.  Anchors
    match gt at 0.7 / 0.3 with the low-quality recovery; invisible
    anchors are neither positive nor negative; the balanced sampler takes
    ``batch_size_per_image`` of them per image.  BCE over the sampled
    anchors and smooth-L1 (beta 1/9) over the sampled positives, both
    divided by the global batch's total sampled count (summed over the
    ranks).  ``rand`` ``[B, 2, N]``
    holds the sampler's priorities (``core/sampler.py``), else drawn from
    ``generator``."""
    b, n = objectness.shape
    if rand is None:
        rand = draw_priorities(b, n, objectness.device, generator)
    matched = match_boxes(
        box_iou(gt_boxes, anchors), gt_valid, fg_iou_threshold, bg_iou_threshold,
        allow_low_quality_matches=True,
    )  # [B, N]
    pos = (matched >= 0) & visibility
    neg = (matched == -1) & visibility
    sampled_pos, sampled_neg = balanced_sample_masks(
        pos, neg, rand, batch_size_per_image, positive_fraction
    )
    sampled = (sampled_pos | sampled_neg).to(objectness.dtype)
    matched_gt = torch.gather(gt_boxes, 1, matched.clamp(min=0)[..., None].expand(-1, -1, 4))
    reg_targets = encode_boxes(matched_gt, anchors, (1.0, 1.0, 1.0, 1.0))
    obj_sum = torch.sum(binary_cross_entropy_with_logits(objectness, pos.to(objectness.dtype)) * sampled)
    box_sum = torch.sum(
        smooth_l1_loss(box_regression, reg_targets, beta=1.0 / 9)
        * sampled_pos.to(box_regression.dtype)[..., None]
    )
    total = global_sum(sampled.sum()).clamp(min=1.0)
    return obj_sum / total, box_sum / total
