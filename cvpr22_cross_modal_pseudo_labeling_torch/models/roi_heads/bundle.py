"""RoIHeadsBundle: C5 extractor + box predictor + mask predictor.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/
roi_heads/bundle.py::RoIHeadsBundle`` (:23), the unit the student-teacher
model builds twice (frozen teacher, trained student).
"""

import torch
from torch import nn

from ..detector.statics import RCNNStatics
from ..resnet import ResNetRoIHead
from .box_head import BoxPredictor
from .mask_head import MaskPredictor
from .pooler import pool_rois


def compute_dtype(s: RCNNStatics) -> torch.dtype:
    return torch.bfloat16 if s.compute_dtype == "bfloat16" else torch.float32


def feature_channels(s: RCNNStatics) -> int:
    """The width of the map the RPN and the RoI heads read: the C4
    stage's and the FPN's are the statics' ``backbone_out_channels``;
    the C5 stage puts out ``8 x res2`` channels, while its statics give
    ``RESNETS.BACKBONE_OUT_CHANNELS`` (1024 by default).  JAX's convs
    infer their input width from the map, so its C5 RPN conv maps the
    trunk's width to ``backbone_out_channels`` and its RoI head gets a
    block-0 downsample whenever ``backbone_out_channels`` is not 2048."""
    if s.conv_body.endswith("-C5"):
        return s.res2_out_channels * 8
    return s.backbone_out_channels


class RoIHeadsBundle(nn.Module):
    """``predictors`` False builds the C5 extractor alone (the WSDDN
    detector, whose JAX tree has no box or mask predictor: flax creates
    a module's parameters when it is first called)."""

    def __init__(self, statics: RCNNStatics, uncertainty: bool = False, predictors: bool = True):
        super().__init__()
        s = statics
        self.statics = s
        dtype = compute_dtype(s)
        self.roi_extractor = ResNetRoIHead(
            in_channels=s.backbone_out_channels,
            num_groups=s.num_groups,
            width_per_group=s.width_per_group,
            stride_in_1x1=s.stride_in_1x1,
            dilation=s.res5_dilation,
            prestrided=s.pool_prestride,
            dtype=dtype,
            feature_channels=feature_channels(s),
        )
        if not predictors:
            return
        self.box_predictor = BoxPredictor(
            emb_dim=s.emb_dim, dtype=dtype, embedding_based=s.embedding_based,
            num_classes=s.num_classes, cls_agnostic_bbox_reg=s.cls_agnostic_bbox_reg,
        )
        if s.mask_on:
            self.mask_predictor = MaskPredictor(
                num_classes=2 if s.cls_agnostic_mask else s.num_classes,
                dim_reduced=s.mask_dim_reduced,
                uncertainty=uncertainty,
                sigma_max=s.uncertainty_sigma_max,
                dtype=dtype,
            )

    def extract(self, feats, boxes):
        """Pools ``[B, S, 4]`` boxes from every level of ``feats`` at the
        config's ``POOLER_SCALES`` and runs the C5 extractor.  Returns
        ``[B*S, 7, 7, 2048]`` in the compute dtype on the C4 body, ``[B*S,
        14, 14, 2048]`` on the FPN body with the prestrided head (the
        multi-level pooler emits every bin, as JAX's).  The pooler reads the
        compute-dtype features and writes their dtype with float32
        arithmetic in between, which is the JAX bundle's float32 pooling
        followed by its cast, without the two casting passes."""
        s = self.statics
        pooled = pool_rois(
            feats,
            boxes,
            (s.pooler_resolution, s.pooler_resolution),
            s.pooler_scales,
            s.pooler_sampling_ratio,
            bin_stride=2 if s.pool_prestride else 1,
        )
        return self.roi_extractor(pooled)

    def box_outputs(self, x, class_embeddings=None):
        """``(logits, deltas, emb)`` of the box predictor on the pooled
        RoI vectors; ``class_embeddings`` only for the embedding-based
        predictor."""
        return self.box_predictor(x.mean(dim=(1, 2)), class_embeddings)

    def mask_outputs(self, x, compute_uncertain=False, train=False, eps=None, generator=None):
        """``(logits, scale)`` of the mask predictor; in training with
        ``compute_uncertain`` the logits carry ``uncertainty_samples``
        reparameterized draws (``eps`` or ``generator``)."""
        return self.mask_predictor(
            x, compute_uncertain=compute_uncertain, train=train,
            num_samples=self.statics.uncertainty_samples, eps=eps, generator=generator,
        )
