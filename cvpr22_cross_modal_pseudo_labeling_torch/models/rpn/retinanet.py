"""RetinaNet: statics, head, loss and inference.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/rpn/
retinanet.py`` (``RetinaNetStatics`` and ``retinanet_statics_from_cfg``
:30-79, ``retinanet_anchor_sizes`` :82, ``RetinaNetHead`` :95,
``retinanet_loss`` :141, ``retinanet_inference`` :194, ``RetinaNet``
:246).  Anchors: one size a level scaled over ``SCALES_PER_OCTAVE``
octaves; the head: two towers of ``NUM_CONVS`` 3x3 convs shared over the
levels, normal(0.01) kernels and the prior-probability bias on
``cls_logits``; the loss: the sigmoid focal loss over every anchor over
the positives plus the images, and smooth-L1 on the positives; inference:
each level's top-k of the class scores, decoded and clipped, then one
label-gated NMS over the levels (the port's NMS kernel on the card).

As in JAX, the body is the R-FPN-RETINANET trunk at its own widths (stem
64, res2 256, 256 FPN channels): ``MODEL.RESNETS``'s widths and
``BACKBONE_OUT_CHANNELS`` do not reach it through the config.  The
module takes them as arguments for narrow models built directly.
"""

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.box_coder import decode_boxes, encode_boxes
from ...core.boxes import box_iou, clip_to_image
from ...core.matcher import BETWEEN_THRESHOLDS, match_boxes
from ...ops.losses import smooth_l1_loss
from ...ops.nms import batched_nms
from ...ops.sigmoid_focal_loss import sigmoid_focal_loss
from ...parallel.dist import global_sum
from ..backbone import ResNetFPNBackbone, device_normalize
from ..layers import Conv2d
from ..roi_heads.box_head import Detections
from .anchors import build_anchors_for_levels
from .rpn import top_k

# the (10, 10, 5, 5) coder feeds both the loss and the inference, as one
# BoxCoder does in the reference (retinanet.py:101)
RETINANET_BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


class RetinaNetStatics(NamedTuple):
    num_classes: int = 81  # includes background at 0
    anchor_sizes: Tuple[float, ...] = (32, 64, 128, 256, 512)
    anchor_strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    octave: float = 2.0
    scales_per_octave: int = 3
    num_convs: int = 4
    prior_prob: float = 0.01
    fg_iou: float = 0.5
    bg_iou: float = 0.4
    bbox_reg_weight: float = 4.0
    bbox_reg_beta: float = 0.11
    loss_alpha: float = 0.25
    loss_gamma: float = 2.0
    pre_nms_top_n: int = 1000
    inference_th: float = 0.05
    nms_th: float = 0.4
    detections_per_img: int = 100
    # device-side uint8 normalization (models/backbone.py)
    pixel_mean: Tuple[float, ...] = (102.9801, 115.9465, 122.7717)
    pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    to_bgr255: bool = True


def retinanet_statics_from_cfg(cfg) -> RetinaNetStatics:
    r = cfg.MODEL.RETINANET
    return RetinaNetStatics(
        num_classes=r.NUM_CLASSES,
        anchor_sizes=tuple(r.ANCHOR_SIZES),
        anchor_strides=tuple(r.ANCHOR_STRIDES),
        aspect_ratios=tuple(r.ASPECT_RATIOS),
        octave=r.OCTAVE,
        scales_per_octave=r.SCALES_PER_OCTAVE,
        num_convs=r.NUM_CONVS,
        prior_prob=r.PRIOR_PROB,
        fg_iou=r.FG_IOU_THRESHOLD,
        bg_iou=r.BG_IOU_THRESHOLD,
        bbox_reg_weight=r.BBOX_REG_WEIGHT,
        bbox_reg_beta=r.BBOX_REG_BETA,
        loss_alpha=r.LOSS_ALPHA,
        loss_gamma=r.LOSS_GAMMA,
        pre_nms_top_n=r.PRE_NMS_TOP_N,
        inference_th=r.INFERENCE_TH,
        nms_th=r.NMS_TH,
        detections_per_img=cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
        pixel_mean=tuple(cfg.INPUT.PIXEL_MEAN),
        pixel_std=tuple(cfg.INPUT.PIXEL_STD),
        to_bgr255=cfg.INPUT.TO_BGR255,
    )


def retinanet_anchor_sizes(s: RetinaNetStatics) -> List[Tuple[float, ...]]:
    """Each level's sizes: its size times ``octave ** (i / scales)``."""
    return [
        tuple(size * s.octave ** (i / float(s.scales_per_octave)) for i in range(s.scales_per_octave))
        for size in s.anchor_sizes
    ]


class RetinaNetHead(nn.Module):
    """The classification and box towers, shared over the levels."""

    def __init__(self, s: RetinaNetStatics, in_channels: int = 256, dtype=torch.float32):
        super().__init__()
        self.num_convs = s.num_convs
        num_anchors = len(s.aspect_ratios) * s.scales_per_octave
        for i in range(s.num_convs):
            self.add_module(f"cls_tower{i}", Conv2d(in_channels, in_channels, 3, padding=1, dtype=dtype))
        for i in range(s.num_convs):
            self.add_module(f"bbox_tower{i}", Conv2d(in_channels, in_channels, 3, padding=1, dtype=dtype))
        self.cls_logits = Conv2d(in_channels, num_anchors * (s.num_classes - 1), 3, padding=1, dtype=dtype)
        self.bbox_pred = Conv2d(in_channels, num_anchors * 4, 3, padding=1, dtype=dtype)
        # JAX's initializers: normal(0.01) kernels, zero biases, and the
        # classification bias that starts every score at prior_prob
        for m in self.children():
            nn.init.normal_(m.weight, std=0.01)
            nn.init.zeros_(m.bias)
        nn.init.constant_(self.cls_logits.bias, -math.log((1 - s.prior_prob) / s.prior_prob))

    def forward(self, features: Sequence[torch.Tensor]):
        """``[B, H, W, C]`` per level -> class logits ``[B, H, W,
        A * (C - 1)]`` and box regression ``[B, H, W, 4A]`` per level."""
        logits, bbox_reg = [], []
        for f in features:
            x = f.permute(0, 3, 1, 2)
            c, b = x, x
            for i in range(self.num_convs):
                c = F.relu(getattr(self, f"cls_tower{i}")(c))
                b = F.relu(getattr(self, f"bbox_tower{i}")(b))
            logits.append(self.cls_logits(c).permute(0, 2, 3, 1))
            bbox_reg.append(self.bbox_pred(b).permute(0, 2, 3, 1))
        return logits, bbox_reg


def retinanet_loss(
    anchors: torch.Tensor,
    cls_logits: torch.Tensor,
    box_regression: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    s: RetinaNetStatics,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(classification, regression) losses, batched over the images.

    anchors ``[N, 4]``; cls_logits ``[B, N, C - 1]`` and box_regression
    ``[B, N, 4]``, float32; gt ``[B, G, ...]``.  Anchors match the gt at
    ``fg_iou`` / ``bg_iou`` with the low-quality matches; the anchors
    between the thresholds are ignored.  The focal loss sums over the
    classes of the positive and negative anchors and is divided by the
    positives plus the images; smooth-L1 (beta ``bbox_reg_beta``) on the
    positives' (10, 10, 5, 5) targets, divided by ``max(1, positives *
    bbox_reg_weight)``.  The positives and the images are the global
    batch's: on more than one rank each loss is this rank's share."""
    matched = match_boxes(box_iou(gt_boxes, anchors), gt_valid, s.fg_iou, s.bg_iou,
                          allow_low_quality_matches=True)  # [B, N]
    pos = matched >= 0
    idx = matched.clamp(min=0)
    labels = torch.where(pos, torch.gather(gt_labels.to(torch.int64), 1, idx), 0)
    labels = torch.where(matched == BETWEEN_THRESHOLDS, -1, labels)
    cls = sigmoid_focal_loss(cls_logits, labels, s.loss_gamma, s.loss_alpha).sum(dim=-1)
    cls_sums = torch.sum(cls * (labels >= 0).to(cls.dtype), dim=1)
    reg_targets = encode_boxes(torch.gather(gt_boxes, 1, idx[..., None].expand(-1, -1, 4)), anchors,
                               RETINANET_BOX_WEIGHTS)
    reg_sums = torch.sum(
        smooth_l1_loss(box_regression, reg_targets, beta=s.bbox_reg_beta) * pos[..., None].to(cls.dtype),
        dim=(1, 2),
    )
    # the positives and the images of the global batch, in one reduction
    total_pos, b = global_sum(torch.stack([
        pos.sum().to(torch.float32), torch.full((), float(cls_logits.shape[0]), device=pos.device)])).unbind()
    one = torch.ones((), device=total_pos.device)
    # tensor divisors: CUDA divides by a Python scalar as a multiplication
    # by its reciprocal
    return (
        torch.sum(cls_sums) / (total_pos + b),
        torch.sum(reg_sums) / torch.maximum(total_pos * s.bbox_reg_weight, one),
    )


def retinanet_inference(
    anchor_list: List[torch.Tensor],
    cls_logits: List[torch.Tensor],
    box_regression: List[torch.Tensor],
    image_sizes: torch.Tensor,
    s: RetinaNetStatics,
) -> Detections:
    """Each level's top ``pre_nms_top_n`` (anchor, class) scores (the
    stable-sort ``top_k``: bfloat16 logits tie in bulk, and ``lax.top_k``
    keeps the lower index first), decoded against their anchors and
    clipped, valid above ``inference_th``; then one NMS over all levels,
    gated by label (one launch for the batch), down to
    ``detections_per_img``.  Labels are 1..C-1."""
    b = cls_logits[0].shape[0]
    num_fg = s.num_classes - 1
    all_boxes, all_scores, all_labels, all_valid = [], [], [], []
    for anchors, logits, reg in zip(anchor_list, cls_logits, box_regression):
        n = anchors.shape[0]
        flat = torch.sigmoid(logits.reshape(b, n, num_fg).to(torch.float32)).reshape(b, n * num_fg)
        topv, topi = top_k(flat, min(s.pre_nms_top_n, flat.shape[1]))
        a_idx = torch.div(topi, num_fg, rounding_mode="floor")
        reg_sel = torch.gather(reg.reshape(b, n, 4).to(torch.float32), 1, a_idx[..., None].expand(-1, -1, 4))
        boxes = decode_boxes(reg_sel, anchors[a_idx], RETINANET_BOX_WEIGHTS)
        all_boxes.append(clip_to_image(boxes, image_sizes))
        all_scores.append(topv)
        all_labels.append((topi % num_fg + 1).to(torch.int32))
        all_valid.append(topv > s.inference_th)
    boxes = torch.cat(all_boxes, dim=1)
    scores = torch.cat(all_scores, dim=1)
    labels = torch.cat(all_labels, dim=1)
    idx, keep = batched_nms(boxes, scores, labels, torch.cat(all_valid, dim=1), s.nms_th,
                            s.detections_per_img)
    idx = idx.to(torch.int64)
    return Detections(
        boxes=torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
        scores=torch.gather(scores, 1, idx),
        labels=torch.gather(labels, 1, idx),
        valid=keep,
    )


class RetinaNet(nn.Module):
    """The single-stage detector: the R-FPN-RETINANET body (P3..P7) and
    the head.  The module names are the flax scopes (``backbone``,
    ``head``), so ``bridge.py`` maps the parameters by path.  ``trunk``
    passes the ResNet's widths (``stem_out_channels``,
    ``res2_out_channels``, ``width_per_group``, ...) to the body; the
    config's detector passes none."""

    def __init__(self, statics: RetinaNetStatics, backbone_depth: str = "R-50",
                 backbone_out_channels: int = 256, dtype=torch.float32,
                 trunk: Optional[Dict] = None):
        super().__init__()
        self.statics = statics
        self.backbone = ResNetFPNBackbone(depth=backbone_depth, out_channels=backbone_out_channels,
                                          retinanet=True, dtype=dtype, **(trunk or {}))
        self.head = RetinaNetHead(statics, backbone_out_channels, dtype)
        self._anchors: Dict[Tuple, List[torch.Tensor]] = {}

    def anchors(self, feats) -> List[torch.Tensor]:
        """Each level's ``[H_l * W_l * A, 4]`` anchors, built once per
        shape and device (anew, and not kept, while ``torch.export``
        traces: the trace's tensors are fake)."""
        key = (tuple(tuple(f.shape[1:3]) for f in feats), feats[0].device)
        if key not in self._anchors or torch.compiler.is_compiling():
            s = self.statics
            anchors = build_anchors_for_levels(
                list(key[0]), s.anchor_strides, retinanet_anchor_sizes(s), s.aspect_ratios, key[1])
            if torch.compiler.is_compiling():
                return anchors
            self._anchors[key] = anchors
        return self._anchors[key]

    def forward(self, images, image_sizes, targets: Optional[Dict[str, torch.Tensor]] = None,
                train: bool = False):
        """images ``[B, H, W, 3]`` uint8 (or normalized float);
        image_sizes ``[B, 2]``.  Training reads ``gt_boxes``, ``gt_labels``
        and ``gt_valid`` from ``targets`` and returns
        ``{"loss_retina_cls", "loss_retina_reg"}``; eval returns the
        :class:`Detections`."""
        s = self.statics
        images = device_normalize(images, image_sizes, s.pixel_mean, s.pixel_std, s.to_bgr255)
        feats = self.backbone(images)
        logits, reg = self.head(feats)
        anchor_list = self.anchors(feats)
        if not train:
            return retinanet_inference(anchor_list, logits, reg, image_sizes, s)
        b = images.shape[0]
        num_fg = s.num_classes - 1
        cls_loss, reg_loss = retinanet_loss(
            torch.cat(anchor_list, dim=0),
            torch.cat([x.reshape(b, -1, num_fg) for x in logits], dim=1).to(torch.float32),
            torch.cat([x.reshape(b, -1, 4) for x in reg], dim=1).to(torch.float32),
            targets["gt_boxes"].to(torch.float32),
            targets["gt_labels"],
            targets["gt_valid"].to(torch.bool),
            s,
        )
        return {"loss_retina_cls": cls_loss, "loss_retina_reg": reg_loss}
