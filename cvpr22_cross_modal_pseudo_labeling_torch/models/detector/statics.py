"""Frozen static configuration extracted from the CfgNode for module
construction.

The port's own copy of the JAX package's ``models/detector/statics.py``,
field for field, so both packages read a config the same way.  Fields
that only shape the TPU program (``s2d_stem``, ``nms_tile``) are carried
and ignored: the port always runs the plain 7x7 stem, and its NMS kernel
has no tile size."""

from typing import NamedTuple, Tuple


class RCNNStatics(NamedTuple):
    # backbone
    conv_body: str = "R-50-C4"
    stem_out_channels: int = 64
    res2_out_channels: int = 256
    num_groups: int = 1
    width_per_group: int = 64
    stride_in_1x1: bool = True
    res5_dilation: int = 1
    # TPU.S2D_STEM: exact space-to-depth stem rewrite (resnet.py)
    s2d_stem: bool = False
    backbone_out_channels: int = 1024
    feature_strides: Tuple[int, ...] = (16,)
    # rpn
    anchor_sizes: Tuple[float, ...] = (32, 64, 128, 256, 512)
    anchor_stride: Tuple[int, ...] = (16,)
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    straddle_thresh: float = 0.0
    rpn_fg_iou: float = 0.7
    rpn_bg_iou: float = 0.3
    rpn_batch_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    rpn_pre_nms_train: int = 12000
    rpn_pre_nms_test: int = 6000
    rpn_post_nms_train: int = 2000
    rpn_post_nms_test: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 0.0
    # FPN cross-level selection (reference rpn/inference.py:154-181)
    fpn_post_nms_train: int = 2000
    fpn_post_nms_test: int = 2000
    fpn_post_nms_per_batch: bool = True
    # FPN_POST_NMS_PER_BATCH granularity: the reference applies the
    # cross-level top-N per GPU minibatch; under SPMD the in-step batch
    # is global, so it is split into this many contiguous groups (the
    # data-shard count).  1 = single-process reference semantics.
    fpn_per_batch_groups: int = 1
    rpn_dont_train: bool = False
    rpn_only: bool = False
    # roi heads
    roi_fg_iou: float = 0.5
    roi_bg_iou: float = 0.5
    roi_batch_per_image: int = 512
    roi_positive_fraction: float = 0.25
    reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 100
    gt_box_eval: bool = False
    # box head
    embedding_based: bool = True
    emb_dim: int = 768
    num_classes: int = 81
    cls_agnostic_bbox_reg: bool = True
    bg_weight: float = 1.0
    pooler_resolution: int = 14
    pooler_scales: Tuple[float, ...] = (1.0 / 16,)
    pooler_sampling_ratio: int = 0
    # pool only the even 14x14 bins (7x7) and run C5 with first_stride
    # 1 — bit-identical when the C5 head is stride_in_1x1 stride-2
    # (both 1x1 convs read even positions only), 4x less pooling work.
    # Forced off when stride_in_1x1 is False or res5_dilation != 1.
    pool_prestride: bool = True
    # mask head
    mask_on: bool = True
    mask_resolution: int = 14
    cls_agnostic_mask: bool = True
    uncertainty: bool = False
    # reparameterized-loss estimator ("sampled_bce" reference parity |
    # "logmeanexp" Kendall-Gal attenuation) and sample count; the
    # reference hardcodes 1 sample (roi_mask_predictors.py:47)
    uncertainty_estimator: str = "sampled_bce"
    uncertainty_samples: int = 1
    # sigma cap for the uncertainty head (0.0 = unbounded, parity);
    # required for stable "logmeanexp" training under heavy label noise
    uncertainty_sigma_max: float = 0.0
    mask_dim_reduced: int = 256
    # keypoint head (MODEL.KEYPOINT_ON, reference roi_heads.py:57-62)
    keypoint_on: bool = False
    num_keypoints: int = 17
    # WSDDN weakly-supervised box head (MODEL.ROI_BOX_HEAD.WSDDN,
    # reference box_head.py:88-89)
    wsddn: bool = False
    # caps
    max_gt: int = 100
    nms_tile: int = 512
    # mask head trains on at most this many sampled rois per image; the
    # sampler orders positives first, so the slice covers all positives
    # whenever #pos <= cap (the reference computes masks for positives
    # only — keep_only_positive_boxes, mask_head.py:13-33)
    mask_pos_cap: int = 256
    # dtype name ("float32" | "bfloat16")
    compute_dtype: str = "float32"
    # device-side normalization of uint8 image batches (INPUT.PIXEL_*,
    # defaults.py:62-65; applied by models/backbone.py:device_normalize
    # when the batch arrives as uint8)
    pixel_mean: Tuple[float, ...] = (102.9801, 115.9465, 122.7717)
    pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    to_bgr255: bool = True


def statics_from_cfg(cfg, data_shards: int = 1) -> RCNNStatics:
    m = cfg.MODEL
    return RCNNStatics(
        conv_body=m.BACKBONE.CONV_BODY,
        stem_out_channels=m.RESNETS.STEM_OUT_CHANNELS,
        res2_out_channels=m.RESNETS.RES2_OUT_CHANNELS,
        num_groups=m.RESNETS.NUM_GROUPS,
        width_per_group=m.RESNETS.WIDTH_PER_GROUP,
        stride_in_1x1=m.RESNETS.STRIDE_IN_1X1,
        res5_dilation=m.RESNETS.RES5_DILATION,
        s2d_stem=cfg.TPU.S2D_STEM,
        backbone_out_channels=(
            m.RESNETS.RES2_OUT_CHANNELS * 4
            if m.BACKBONE.CONV_BODY.endswith("-C4")
            else m.RESNETS.BACKBONE_OUT_CHANNELS
        ),
        anchor_sizes=tuple(m.RPN.ANCHOR_SIZES),
        anchor_stride=tuple(m.RPN.ANCHOR_STRIDE),
        aspect_ratios=tuple(m.RPN.ASPECT_RATIOS),
        straddle_thresh=float(m.RPN.STRADDLE_THRESH),
        rpn_fg_iou=m.RPN.FG_IOU_THRESHOLD,
        rpn_bg_iou=m.RPN.BG_IOU_THRESHOLD,
        rpn_batch_per_image=m.RPN.BATCH_SIZE_PER_IMAGE,
        rpn_positive_fraction=m.RPN.POSITIVE_FRACTION,
        rpn_pre_nms_train=m.RPN.PRE_NMS_TOP_N_TRAIN,
        rpn_pre_nms_test=m.RPN.PRE_NMS_TOP_N_TEST,
        rpn_post_nms_train=m.RPN.POST_NMS_TOP_N_TRAIN,
        rpn_post_nms_test=m.RPN.POST_NMS_TOP_N_TEST,
        rpn_nms_thresh=m.RPN.NMS_THRESH,
        rpn_min_size=float(m.RPN.MIN_SIZE),
        fpn_post_nms_train=m.RPN.FPN_POST_NMS_TOP_N_TRAIN,
        fpn_post_nms_test=m.RPN.FPN_POST_NMS_TOP_N_TEST,
        fpn_post_nms_per_batch=m.RPN.FPN_POST_NMS_PER_BATCH,
        fpn_per_batch_groups=max(int(data_shards), 1),
        rpn_dont_train=m.RPN.DONT_TRAIN,
        rpn_only=m.RPN_ONLY,
        roi_fg_iou=m.ROI_HEADS.FG_IOU_THRESHOLD,
        roi_bg_iou=m.ROI_HEADS.BG_IOU_THRESHOLD,
        roi_batch_per_image=m.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
        roi_positive_fraction=m.ROI_HEADS.POSITIVE_FRACTION,
        reg_weights=tuple(m.ROI_HEADS.BBOX_REG_WEIGHTS),
        # GT_BOX_EVAL forces thresholds that keep every boosted gt box
        # (make_roi_box_post_processor, box_head/inference.py:177-180)
        score_thresh=1.0 if m.GT_BOX_EVAL else m.ROI_HEADS.SCORE_THRESH,
        nms_thresh=1.0 if m.GT_BOX_EVAL else m.ROI_HEADS.NMS,
        gt_box_eval=m.GT_BOX_EVAL,
        detections_per_img=m.ROI_HEADS.DETECTIONS_PER_IMG,
        keypoint_on=m.KEYPOINT_ON,
        num_keypoints=m.ROI_KEYPOINT_HEAD.NUM_CLASSES,
        wsddn=m.ROI_BOX_HEAD.WSDDN,
        embedding_based=m.ROI_BOX_HEAD.EMBEDDING_BASED,
        emb_dim=m.ROI_BOX_HEAD.EMB_DIM,
        num_classes=m.ROI_BOX_HEAD.NUM_CLASSES,
        cls_agnostic_bbox_reg=m.CLS_AGNOSTIC_BBOX_REG,
        bg_weight=m.ROI_BOX_HEAD.LOSS_WEIGHT_BACKGROUND,
        pooler_resolution=m.ROI_BOX_HEAD.POOLER_RESOLUTION,
        pooler_scales=tuple(m.ROI_BOX_HEAD.POOLER_SCALES),
        pooler_sampling_ratio=m.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
        pool_prestride=(
            cfg.TPU.POOL_PRESTRIDE
            and m.RESNETS.STRIDE_IN_1X1
            and m.RESNETS.RES5_DILATION == 1
        ),
        mask_on=m.MASK_ON,
        mask_resolution=m.ROI_MASK_HEAD.RESOLUTION,
        cls_agnostic_mask=m.CLS_AGNOSTIC_MASK,
        uncertainty=m.UNCERTAINTY,
        uncertainty_estimator=m.ROI_MASK_HEAD.UNCERTAINTY_ESTIMATOR,
        uncertainty_samples=m.ROI_MASK_HEAD.UNCERTAINTY_SAMPLES,
        uncertainty_sigma_max=m.ROI_MASK_HEAD.UNCERTAINTY_SIGMA_MAX,
        mask_dim_reduced=m.ROI_MASK_HEAD.CONV_LAYERS[-1],
        max_gt=cfg.TPU.MAX_GT,
        nms_tile=cfg.TPU.NMS_TILE,
        mask_pos_cap=cfg.TPU.MASK_POS_CAP,
        compute_dtype=cfg.TPU.COMPUTE_DTYPE,
        pixel_mean=tuple(cfg.INPUT.PIXEL_MEAN),
        pixel_std=tuple(cfg.INPUT.PIXEL_STD),
        to_bgr255=cfg.INPUT.TO_BGR255,
    )
