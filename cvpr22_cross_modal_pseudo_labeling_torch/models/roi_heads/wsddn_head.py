"""WSDDN weakly-supervised box head (``MODEL.ROI_BOX_HEAD.WSDDN``).

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/
roi_heads/wsddn_head.py`` (``WSDDNHead`` :20, ``wsddn_inference`` :55,
``wsddn_loss`` :93): two linear streams on the pooled RoI vectors, one
softmaxed over the classes and one over the image's valid proposals,
multiplied into per-proposal class scores whose sum over the proposals
is the image's score of each class.  Training is a mean binary
cross-entropy against image-level labels; inference keeps the proposal
boxes (no regression), takes the best ``10 x DETECTIONS_PER_IMG``
(proposal, class) scores over the foreground classes with the
stable-sort ``top_k`` (``lax.top_k``'s tie order) and runs the
label-gated NMS.  The head computes in float32 on float32 input, as the
JAX head does whatever ``TPU.COMPUTE_DTYPE`` says.
"""

from typing import Tuple

import torch
from torch import nn

from ...ops.nms import batched_nms
from ..layers import Linear
from ..rpn.rpn import top_k
from .box_head import Detections


class WSDDNHead(nn.Module):
    def __init__(self, in_features: int, num_classes: int):
        """``num_classes`` counts the background slot at 0."""
        super().__init__()
        self.cls_score = Linear(in_features, num_classes)
        self.det_score = Linear(in_features, num_classes)

    def forward(self, pooled_vec: torch.Tensor, proposal_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pooled_vec ``[B, S, D]`` float32; proposal_valid ``[B, S]``.
        Returns ``(proposal_scores [B, S, C], image_scores [B, C])``."""
        cls_logits = self.cls_score(pooled_vec)
        det_logits = self.det_score(pooled_vec)
        big_neg = torch.full((), -1e9, dtype=det_logits.dtype, device=det_logits.device)
        cls_sm = torch.softmax(cls_logits, dim=-1)
        det_sm = torch.softmax(torch.where(proposal_valid[..., None], det_logits, big_neg), dim=-2)
        proposal_scores = cls_sm * det_sm
        image_scores = torch.sum(proposal_scores * proposal_valid[..., None], dim=1)
        return proposal_scores, image_scores


def wsddn_inference(proposal_scores: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                    score_thresh: float = 0.0001, nms_thresh: float = 0.5,
                    detections_per_img: int = 100) -> Detections:
    """proposal_scores ``[B, S, C]``, boxes ``[B, S, 4]``, valid ``[B,
    S]`` -> :class:`Detections` of ``detections_per_img`` slots."""
    b, s, num_classes = proposal_scores.shape
    cand = proposal_scores[..., 1:]
    cand_valid = (cand > score_thresh) & valid[..., None]
    flat = torch.where(cand_valid, cand, torch.full((), -1.0, device=cand.device)).reshape(b, -1)
    k = min(10 * detections_per_img, flat.shape[1])
    top_scores, top_idx = top_k(flat, k)
    roi_idx = top_idx // (num_classes - 1)
    cls_idx = top_idx % (num_classes - 1) + 1
    top_boxes = torch.gather(boxes, 1, roi_idx[..., None].expand(-1, -1, 4))
    top_valid = top_scores > score_thresh
    keep_idx, keep_valid = batched_nms(
        top_boxes, top_scores, cls_idx, top_valid, nms_thresh, detections_per_img
    )
    keep_idx = keep_idx.to(torch.int64)
    return Detections(
        boxes=torch.gather(top_boxes, 1, keep_idx[..., None].expand(-1, -1, 4)),
        scores=torch.gather(top_scores, 1, keep_idx),
        labels=torch.gather(cls_idx, 1, keep_idx).to(torch.int32),
        valid=keep_valid,
    )


def wsddn_loss(image_scores: torch.Tensor, image_labels: torch.Tensor,
               background_weight: float = 1.0) -> torch.Tensor:
    """Multi-label image-level BCE: ``-t log p - (1 - t) log(1 - p +
    1e-6) * background_weight`` with ``p`` clipped below at 1e-6, the
    mean over every (image, class) entry."""
    p = image_scores.clamp(min=1e-6)
    neg = torch.log((1.0 - p).clamp(min=0.0) + 1e-6)
    ce = -(image_labels * torch.log(p)) - (1.0 - image_labels) * neg * background_weight
    return ce.mean()
