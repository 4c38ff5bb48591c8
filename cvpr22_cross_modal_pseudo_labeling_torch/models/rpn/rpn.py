"""Region Proposal Network head and test-time proposal selection.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/rpn/
rpn.py`` (``RPNHead`` :28, ``flatten_rpn_outputs`` :61,
``select_proposals_single_level`` :76, the branch of
``select_proposals_multi_level`` that the C4 body takes).  FPN selection
and the RPN loss belong to later slices.
"""

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.box_coder import decode_boxes
from ...core.boxes import clip_to_image, nonempty_mask
from ...ops.nms import nms
from ..layers import Conv2d


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness / 1x1 box heads per level."""

    def __init__(self, in_channels: int, num_anchors: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1, dtype=dtype)
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


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: descending, ties broken by
    the lower index (``torch.topk`` promises no tie order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


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
    (all images in one batched pass).

    anchors ``[N, 4]``; objectness ``[B, N]`` raw logits; box_regression
    ``[B, N, 4]``; image_sizes ``[B, 2]`` (h, w)."""
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

