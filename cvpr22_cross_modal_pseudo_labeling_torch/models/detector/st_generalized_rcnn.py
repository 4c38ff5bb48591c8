"""STGeneralizedRCNN: the student-teacher detector, eval forward.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/detector/
st_generalized_rcnn.py`` (``STStatics`` :62, ``st_statics_from_cfg``
:74, ``normalize_rows`` :87, ``combine_embs`` :226, ``__call__`` :501,
``forward_eval`` :678).  Eval serves the student RoI heads with the
dataset's class table: normalize -> frozen R-50-C4 trunk -> RPN ->
student box head -> per-class NMS -> student mask head.  The module also
holds the teacher bundle, the word-embedding table and
``lambda_exemplar`` so that a full student-teacher checkpoint loads; the
training forward (pseudo-labels and both student branches) is a later
slice.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..backbone import ResNetBackbone, device_normalize
from ..language.bert import WordEmbeddingBackbone
from ..roi_heads.box_head import Detections, postprocess_boxes
from ..roi_heads.bundle import RoIHeadsBundle, compute_dtype
from ..roi_heads.mask_head import mask_head_inference
from ..rpn.anchors import build_anchors_for_levels
from ..rpn.rpn import RPNHead, flatten_rpn_outputs, select_proposals_single_level
from .statics import RCNNStatics, statics_from_cfg


class STStatics(NamedTuple):
    base: RCNNStatics = RCNNStatics()
    lambda_pseudo_label: float = 0.1
    uncertainty: bool = True
    reweight: bool = True
    no_pseudo_mask: bool = False
    vocab_size: int = 30522
    lvis_vocab: int = 1203
    max_cap_nouns: int = 32
    exemplars_enabled: bool = False


def st_statics_from_cfg(cfg, data_shards: int = 1) -> STStatics:
    return STStatics(
        base=statics_from_cfg(cfg, data_shards=data_shards),
        lambda_pseudo_label=cfg.MODEL.LAMBDA_PSEUDO_LABEL,
        uncertainty=cfg.MODEL.UNCERTAINTY,
        reweight=cfg.MODEL.REWEIGHT,
        no_pseudo_mask=cfg.MODEL.NO_PSEUDO_MASK,
        exemplars_enabled=cfg.MODEL.EXEMPLARS_ENABLED,
        lvis_vocab=1203,
        max_cap_nouns=cfg.TPU.MAX_CAP_NOUNS,
    )


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(||x||, eps)`` along the last axis, as sum of squares and
    rsqrt like the JAX function."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(sq.clamp(min=eps * eps))


class RCNNEvalOutput(NamedTuple):
    detections: Detections
    mask_probs: Optional[torch.Tensor]  # [B, D, M, M]


class STGeneralizedRCNN(nn.Module):
    def __init__(self, statics: STStatics):
        super().__init__()
        s = statics.base
        if not s.conv_body.endswith("-C4"):
            raise NotImplementedError(
                f"CONV_BODY {s.conv_body}: only the C4 body is ported yet"
            )
        if not (s.embedding_based and s.cls_agnostic_bbox_reg
                and (s.cls_agnostic_mask or not s.mask_on)):
            raise NotImplementedError(
                "only the embedding-based, class-agnostic box and mask heads "
                "are ported yet"
            )
        self.statics = statics
        dtype = compute_dtype(s)
        self.backbone = ResNetBackbone(
            depth=s.conv_body[:-3],
            stem_out_channels=s.stem_out_channels,
            res2_out_channels=s.res2_out_channels,
            num_groups=s.num_groups,
            width_per_group=s.width_per_group,
            stride_in_1x1=s.stride_in_1x1,
            dtype=dtype,
        )
        self.rpn_head = RPNHead(
            s.backbone_out_channels, len(s.aspect_ratios) * len(s.anchor_sizes), dtype
        )
        self.teacher = RoIHeadsBundle(s, uncertainty=False)
        self.student = RoIHeadsBundle(s, uncertainty=statics.uncertainty)
        self.bert = WordEmbeddingBackbone(statics.vocab_size, s.emb_dim)
        self.lambda_exemplar = nn.Parameter(torch.zeros(1))
        self._anchors: Dict[Tuple, torch.Tensor] = {}

    def combine_embs(self, embs: torch.Tensor) -> torch.Tensor:
        """combine_embs without exemplars: row-normalize the table."""
        return normalize_rows(embs)

    def anchors(self, feat: torch.Tensor) -> torch.Tensor:
        """The C4 level's anchors, cached per feature shape and device."""
        key = (tuple(feat.shape[1:3]), feat.device)
        if key not in self._anchors:
            s = self.statics.base
            (self._anchors[key],) = build_anchors_for_levels(
                [key[0]], s.anchor_stride, s.anchor_sizes, s.aspect_ratios, feat.device
            )
        return self._anchors[key]

    def forward(
        self,
        images: torch.Tensor,
        image_sizes: torch.Tensor,
        class_embeddings: torch.Tensor,
        train: bool = False,
    ) -> RCNNEvalOutput:
        """images ``[B, H, W, 3]`` uint8 (or already-normalized float);
        image_sizes ``[B, 2]`` (h, w); class_embeddings ``[C, emb_dim]``
        with the background row 0."""
        if train:
            raise NotImplementedError(
                "the STGeneralizedRCNN training forward comes with the "
                "training slice of the port; only eval is ported"
            )
        sb = self.statics.base
        x = device_normalize(
            images, image_sizes, sb.pixel_mean, sb.pixel_std, sb.to_bgr255
        )
        feats = self.backbone(x)
        return self.forward_eval(feats, image_sizes, class_embeddings)

    def forward_eval(self, feats, image_sizes, class_embeddings):
        sb = self.statics.base
        obj_l, reg_l = self.rpn_head(feats)
        objectness, box_reg = flatten_rpn_outputs(obj_l, reg_l)
        proposals = select_proposals_single_level(
            self.anchors(feats[0]),
            objectness.to(torch.float32),
            box_reg.to(torch.float32),
            image_sizes,
            sb.rpn_pre_nms_test,
            sb.rpn_post_nms_test,
            sb.rpn_nms_thresh,
            sb.rpn_min_size,
        )
        embs = self.combine_embs(class_embeddings)
        x = self.student.extract(feats, proposals.boxes)
        logits, deltas, _ = self.student.box_outputs(x, embs)
        b, p = proposals.boxes.shape[:2]
        dets = postprocess_boxes(
            logits.to(torch.float32).reshape(b, p, -1),
            deltas.to(torch.float32).reshape(b, p, -1),
            proposals.boxes,
            proposals.valid,
            image_sizes,
            sb.score_thresh,
            sb.nms_thresh,
            sb.detections_per_img,
            pre_nms_candidates=min(
                10 * sb.detections_per_img, p * max(logits.shape[-1] - 1, 1)
            ),
            reg_weights=sb.reg_weights,
        )
        mask_probs = None
        if sb.mask_on:
            x2 = self.student.extract(feats, dets.boxes)
            mask_logits = self.student.mask_outputs(x2)
            probs = mask_head_inference(mask_logits.to(torch.float32))
            m = probs.shape[-1]
            mask_probs = probs.reshape(b, -1, m, m)
        return RCNNEvalOutput(dets, mask_probs)
