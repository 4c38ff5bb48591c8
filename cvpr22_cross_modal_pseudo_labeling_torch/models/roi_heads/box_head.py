"""Box predictor and test-time box postprocessing.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/
roi_heads/box_head.py`` (``BoxPredictor`` :45, ``Detections`` :263,
``postprocess_boxes`` :270) for the configuration the port serves: the
embedding-based predictor, which scores RoI embeddings against a class
table passed as an argument, with class-agnostic box regression.  The
``class_valid`` mask of the JAX predictor (class tables padded for a TPU
model mesh axis) has no counterpart.  Sampling and the losses belong to
the training slice.
"""

from typing import NamedTuple, Tuple

import torch
from torch import nn

from ...core.box_coder import decode_boxes
from ...core.boxes import clip_to_image
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
