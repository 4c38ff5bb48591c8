"""GeneralizedRCNN: backbone -> RPN -> RoI heads, the teacher detector.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/detector/
generalized_rcnn.py`` (``RCNNTrainOutput`` :55, ``RCNNEvalOutput`` :60,
``GeneralizedRCNN`` :78 with ``_rpn_forward`` :164,
``_extract_box_features`` :195, ``forward_train`` :241 and
``forward_eval`` :410) on the C4, C5 or FPN body, with either box
predictor: the embedding-based one with class-agnostic regression, which
the paper's first stage trains (``configs/coco_cap_det/zeroshot_mask.yaml``), or
maskrcnn_benchmark's class-specific one (``cls_score`` over
``NUM_CLASSES``, a box per class unless ``CLS_AGNOSTIC_BBOX_REG``), the
JAX defaults and the supervised R-50-C4 Mask and Faster R-CNN; masks
class-agnostic or a channel per class.  Training: the RPN loss, RoI
sampling over the proposals plus the gt boxes, the box loss and the
mask loss on the positives-first slots.  ``MODEL.GT_BOX_EVAL`` scores
given gt boxes in place of the proposals (``gt_eval``).  The backbone runs with
autograd; the optimizer's frozen prefixes (``FREEZE_CONV_BODY_AT``) set
which stages train, and a stage whose parameters and input need no
gradient saves nothing.  The class table is used as it is given (the
student-teacher model normalizes its tables; this model does not); the
class-specific predictor reads none.

The module's attributes are the flax scopes (``backbone``, ``rpn_head``,
``roi_extractor``, ``box_predictor``, ``mask_predictor`` at the top
level), so ``bridge.py`` maps the JAX parameter tree by path: the RoI
heads come from :class:`RoIHeadsBundle`, which this class extends.

The FPN body (``CONV_BODY`` ``R-50-FPN`` and the other depths) is JAX's,
not maskrcnn_benchmark's R-50-FPN Mask R-CNN: the RPN runs on P2..P6 with
one anchor size a level and selects proposals per level
(``select_proposals_multi_level``), and the C5 head of the C4 model
(``ResNetRoIHead``) runs on 14 x 14 RoI features pooled from P2..P5, each
roi from its own level, at every bin whatever ``TPU.POOL_PRESTRIDE`` says
(JAX's multi-level pooler ignores ``bin_stride``): with the prestrided
head (the default) res5 runs at stride 1 on 14 x 14 maps and the mask
head emits 28 x 28 masks.  ``MODEL.FPN.USE_GN`` and ``USE_RELU`` do not
reach the body, as in JAX.

Also here, shared with the student-teacher model: the output types, the
random draws of a training forward (:class:`TrainDraws`) and the pieces
of the forward both detectors run (:func:`check_ported`,
:func:`detector_backbone`, :func:`num_cell_anchors`, :class:`AnchorCache`,
:func:`select_proposals`, :func:`detect`).

The C5 body (``CONV_BODY`` ``R-50-C5``; JAX :98-101) runs the whole
trunk, with res5 at ``RES5_DILATION`` (stride 16 when dilated), under
the RPN and the C5 RoI head; its statics' ``backbone_out_channels`` is
``BACKBONE_OUT_CHANNELS``, not the trunk's width (see
``roi_heads/bundle.py::feature_channels``).  A dilated res5 turns off
``pool_prestride``, so the pooler emits every bin.

The RPN-only detector (``MODEL.RPN_ONLY``, JAX :282 and :428-437) trains
the RPN losses alone and serves the proposals as detections (boxes,
sigmoid objectness as scores, label 0), which ``engine/inference.py::
evaluate_proposals`` scores by recall.  ``MODEL.KEYPOINT_ON`` (JAX
:141-147, :385-406, :500-513) adds the keypoint head on the box head's
RoI features: its loss on the positives-first slots the mask head takes,
against the matched gt keypoints (``batch["gt_keypoints"]``), and its
``[B, D, K, 3]`` keypoints (x, y, score) of the detections.
``MODEL.ROI_BOX_HEAD.WSDDN`` (JAX :149-154, :285-321, :452-466) replaces
the box head: training scores every proposal with no RoI sampling and
trains on image-level labels (from the gt classes when the batch has no
``image_labels``), eval serves the proposal boxes with the WSDDN scores;
masks and keypoints are neither trained nor served then, as in JAX.

The teacher's pseudo-label methods (JAX :517 and :546), which no JAX
detector calls: :meth:`GeneralizedRCNN.run_teacher_pseudo_branch` (the
test-time proposals, their region embeddings and class logits, and the
class-agnostic regressed boxes, clipped: :class:`TeacherPseudoOutput`)
and :meth:`GeneralizedRCNN.predict_masks_for_boxes` (the mask head's
probabilities on given boxes).  The training forward takes
``pseudo_sample_weights`` (each sampled roi's classification weight,
JAX :217) and ``lambda_mask``, which JAX accepts and never reads.

Not ported, and refused: the ``class_valid`` row mask (it serves only
class tables padded to a TPU mesh axis).
"""

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ...core.box_coder import decode_boxes
from ...core.boxes import clip_to_image
from ..backbone import ResNetBackbone, ResNetFPNBackbone, device_normalize
from ..roi_heads.box_head import Detections, box_head_loss, postprocess_boxes, subsample_rois
from ..roi_heads.bundle import RoIHeadsBundle, compute_dtype, feature_channels
from ..roi_heads.keypoint_head import KeypointPredictor, keypoint_inference, keypoint_loss
from ..roi_heads.mask_head import mask_head_inference, mask_head_loss
from ..roi_heads.wsddn_head import WSDDNHead, wsddn_inference, wsddn_loss
from ..rpn.anchors import anchor_visibility, build_anchors_for_levels
from ..rpn.rpn import RPNHead, RPNProposals, flatten_rpn_outputs, rpn_loss, select_proposals_multi_level
from .statics import RCNNStatics


class RCNNEvalOutput(NamedTuple):
    detections: Detections
    mask_probs: Optional[torch.Tensor]  # [B, D, M, M]
    keypoints: Optional[torch.Tensor] = None  # [B, D, K, 3] (x, y, score)


class RCNNTrainOutput(NamedTuple):
    losses: Dict[str, torch.Tensor]
    info: Dict[str, torch.Tensor]


class TeacherPseudoOutput(NamedTuple):
    proposals: RPNProposals  # [B, P] at the test-time caps
    embeddings: torch.Tensor  # [B, P, emb_dim] region embeddings
    class_logits: torch.Tensor  # [B, P, C] against the given class table
    boxes: torch.Tensor  # [B, P, 4] regressed (class-agnostic) and clipped


class TrainDraws(NamedTuple):
    """Random draws of one training forward; a None field is drawn from
    the generator.  The RoI and RPN samplers' positive and negative
    priorities: ``pseudo_sampler`` ``[B, 2, P_test]`` (the student-teacher
    caption branch), ``gt_sampler`` ``[B, 2, P_train + G]`` (the
    detection branch, or the teacher's RoI sampler), ``rpn_sampler``
    ``[B, 2, N_anchors]`` (the teacher's RPN loss); ``mask_eps`` ``[n_s,
    B * cap, M, M, 2]``: the mask uncertainty's samples, in the mask
    logits' dtype."""

    pseudo_sampler: Optional[torch.Tensor] = None
    gt_sampler: Optional[torch.Tensor] = None
    mask_eps: Optional[torch.Tensor] = None
    rpn_sampler: Optional[torch.Tensor] = None


def check_ported(s: RCNNStatics) -> None:
    """Raises NotImplementedError for a configuration the port does not
    run yet, and ValueError for one that JAX cannot run either."""
    if s.conv_body.endswith("-FPN-RETINANET"):
        # JAX's GeneralizedRCNN reads it as an FPN depth and fails
        raise ValueError(
            f"CONV_BODY {s.conv_body} is RetinaNet's body: set MODEL.RETINANET_ON True"
        )
    if not s.conv_body.endswith(("-C4", "-C5", "-FPN")):
        raise NotImplementedError(
            f"CONV_BODY {s.conv_body}: only the C4, C5 and FPN bodies are ported yet"
        )
    if s.embedding_based and not s.cls_agnostic_bbox_reg:
        # the JAX predictor regresses one box: its per-class reshape fails
        raise ValueError(
            "the embedding-based box predictor regresses one class-agnostic box: "
            "set MODEL.CLS_AGNOSTIC_BBOX_REG True"
        )


def detector_backbone(s: RCNNStatics, dilate_res5: bool = True):
    """The C4 body, the C5 body (res5 at ``RES5_DILATION`` unless
    ``dilate_res5`` is False: JAX's student-teacher model builds its C5
    trunk undilated, ``st_generalized_rcnn.py:186-190``), or the FPN body
    (the trunk's options and ``out_channels`` only, as the JAX detectors
    build it)."""
    common = dict(
        stem_out_channels=s.stem_out_channels,
        res2_out_channels=s.res2_out_channels,
        num_groups=s.num_groups,
        width_per_group=s.width_per_group,
        stride_in_1x1=s.stride_in_1x1,
        dtype=compute_dtype(s),
    )
    if s.conv_body.endswith("-FPN"):
        return ResNetFPNBackbone(
            depth=s.conv_body[: -len("-FPN")], out_channels=s.backbone_out_channels, **common
        )
    if s.conv_body.endswith("-C5"):
        return ResNetBackbone(
            depth=s.conv_body[:-3], num_stages=4,
            res5_dilation=s.res5_dilation if dilate_res5 else 1, **common
        )
    return ResNetBackbone(depth=s.conv_body[:-3], **common)


def num_cell_anchors(s: RCNNStatics) -> int:
    """Anchors a feature cell: every size on the one level of a C4 RPN,
    one size a level with several strides (FPN)."""
    return len(s.aspect_ratios) * (len(s.anchor_sizes) if len(s.anchor_stride) == 1 else 1)


class AnchorCache:
    """Each level's anchors and their concatenation, built once per
    shape of every level and device."""

    def __init__(self, s: RCNNStatics):
        self.statics = s
        self._anchors: Dict[Tuple, Tuple[List[torch.Tensor], torch.Tensor]] = {}

    def __call__(self, feats) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """``(anchor_list, anchors)``: ``[H_l*W_l*A, 4]`` a level, in the
        order of ``flatten_rpn_outputs``, and all of them concatenated."""
        key = (tuple(tuple(f.shape[1:3]) for f in feats), feats[0].device)
        if key not in self._anchors:
            s = self.statics
            anchor_list = build_anchors_for_levels(
                list(key[0]), s.anchor_stride, s.anchor_sizes, s.aspect_ratios, key[1]
            )
            self._anchors[key] = (anchor_list, torch.cat(anchor_list, dim=0))
        return self._anchors[key]


def select_proposals(s: RCNNStatics, anchor_list, objectness, box_reg, image_sizes,
                     train: bool) -> RPNProposals:
    """The train or test selector of the config on float32 inputs: one
    level, or each level then the FPN top-N (with the per-batch quirk
    in training under ``FPN_POST_NMS_PER_BATCH``)."""
    return select_proposals_multi_level(
        anchor_list,
        objectness.to(torch.float32),
        box_reg.to(torch.float32),
        image_sizes,
        s.rpn_pre_nms_train if train else s.rpn_pre_nms_test,
        s.rpn_post_nms_train if train else s.rpn_post_nms_test,
        s.rpn_nms_thresh,
        s.rpn_min_size,
        fpn_post_nms_top_n=s.fpn_post_nms_train if train else s.fpn_post_nms_test,
        fpn_post_nms_per_batch=train and s.fpn_post_nms_per_batch,
        per_batch_groups=s.fpn_per_batch_groups,
    )


def detect(heads: RoIHeadsBundle, feats, proposals: RPNProposals, image_sizes,
           class_embeddings=None, override_labels=None) -> RCNNEvalOutput:
    """The eval RoI heads: box scores (against ``class_embeddings``, used
    as given, for the embedding-based predictor), ``postprocess_boxes``
    (with ``GT_BOX_EVAL``'s ``override_labels``), then the masks of the
    detections."""
    s = heads.statics
    x = heads.extract(feats, proposals.boxes)
    logits, deltas, _ = heads.box_outputs(x, class_embeddings)
    b, p = proposals.boxes.shape[:2]
    dets = postprocess_boxes(
        logits.to(torch.float32).reshape(b, p, -1),
        deltas.to(torch.float32).reshape(b, p, -1),
        proposals.boxes,
        proposals.valid,
        image_sizes,
        s.score_thresh,
        s.nms_thresh,
        s.detections_per_img,
        pre_nms_candidates=min(10 * s.detections_per_img, p * max(logits.shape[-1] - 1, 1)),
        reg_weights=s.reg_weights,
        cls_agnostic_bbox_reg=s.cls_agnostic_bbox_reg,
        gt_override_labels=override_labels,
    )
    mask_probs = None
    if s.mask_on:
        x2 = heads.extract(feats, dets.boxes)
        mask_logits, _ = heads.mask_outputs(x2)
        probs = mask_head_inference(
            mask_logits.to(torch.float32), dets.labels.reshape(-1), s.cls_agnostic_mask
        )
        m = probs.shape[-1]
        mask_probs = probs.reshape(b, -1, m, m)
    return RCNNEvalOutput(dets, mask_probs)


class GeneralizedRCNN(RoIHeadsBundle):
    def __init__(self, statics: RCNNStatics):
        check_ported(statics)
        super().__init__(statics, uncertainty=statics.uncertainty, predictors=not statics.wsddn)
        s = statics
        self.backbone = detector_backbone(s)
        self.rpn_head = RPNHead(
            s.backbone_out_channels, num_cell_anchors(s), compute_dtype(s), feature_channels(s)
        )
        self.anchors = AnchorCache(s)
        if s.keypoint_on:
            # on the box head's RoI features (SHARE_BOX_FEATURE_EXTRACTOR)
            self.keypoint_predictor = KeypointPredictor(
                self.roi_extractor.out_channels, s.num_keypoints, dtype=compute_dtype(s)
            )
        if s.wsddn:
            self.wsddn_head = WSDDNHead(self.roi_extractor.out_channels, s.num_classes)

    def forward(
        self,
        images: torch.Tensor,
        image_sizes: torch.Tensor,
        class_embeddings: Optional[torch.Tensor] = None,
        train: bool = False,
        batch: Optional[Dict[str, torch.Tensor]] = None,
        compute_uncertain: bool = False,
        draws: TrainDraws = TrainDraws(),
        generator: Optional[torch.Generator] = None,
        gt_eval: Optional[Dict[str, torch.Tensor]] = None,
        pseudo_sample_weights: Optional[torch.Tensor] = None,
        lambda_mask: float = 1.0,
    ):
        """images ``[B, H, W, 3]`` uint8 (or already-normalized float);
        image_sizes ``[B, 2]`` (h, w); class_embeddings ``[C, emb_dim]``
        with the background row 0 (the embedding-based predictor's table;
        the class-specific one reads none).

        Eval returns :class:`RCNNEvalOutput`; with ``gt_eval``
        (``MODEL.GT_BOX_EVAL``: ``boxes`` ``[B, G, 4]``, ``labels`` and
        ``valid`` ``[B, G]``) the gt boxes replace the proposals and each
        keeps its own label only.  Training (``train=True``)
        returns :class:`RCNNTrainOutput` and reads the targets from
        ``batch``: ``gt_boxes`` ``[B, G, 4]``, ``gt_labels``, ``gt_valid``
        ``[B, G]`` and ``gt_masks`` ``[B, G, Mr, Mr]``, and with
        ``KEYPOINT_ON`` ``gt_keypoints`` ``[B, G, K, 3]`` (x, y,
        visibility; without them the keypoint head trains nothing, as
        in JAX); WSDDN reads ``image_labels`` ``[B, C]`` when given.
        ``compute_uncertain`` samples the mask uncertainty (when the
        model has it) and reports ``avg_uncertain``; the train step
        leaves it off, as the JAX loss function does.
        ``pseudo_sample_weights`` ``[B, S]`` weighs each sampled roi's
        classification loss; ``lambda_mask`` is read by nothing, as in
        JAX."""
        s = self.statics
        images = device_normalize(images, image_sizes, s.pixel_mean, s.pixel_std, s.to_bgr255)
        if not train:
            return self.forward_eval(images, image_sizes, class_embeddings, gt_eval)
        if batch is None:
            raise ValueError("GeneralizedRCNN training needs `batch`")
        if "class_valid" in batch:
            raise NotImplementedError("the class_valid row mask of padded class tables is not ported")
        return self.forward_train(
            images, image_sizes, class_embeddings, batch, compute_uncertain, draws, generator,
            pseudo_sample_weights,
        )

    def _rpn_forward(self, images, image_sizes, train: bool, select: bool = True):
        """The trunk, the RPN head and (with ``select``) the proposals."""
        feats = self.backbone(images)
        obj_l, reg_l = self.rpn_head(feats)
        objectness, box_reg = flatten_rpn_outputs(obj_l, reg_l)
        anchor_list, anchors = self.anchors(feats)
        proposals = None
        if select:
            proposals = select_proposals(self.statics, anchor_list, objectness, box_reg, image_sizes, train)
        return feats, objectness, box_reg, anchors, proposals

    def forward_train(
        self, images, image_sizes, class_embeddings, batch, compute_uncertain: bool = False,
        draws: TrainDraws = TrainDraws(), generator: Optional[torch.Generator] = None,
        pseudo_sample_weights: Optional[torch.Tensor] = None,
    ) -> RCNNTrainOutput:
        s = self.statics
        # the RPN-only detector trains no RoI head: JAX's compiled step
        # drops its unused proposals, and the port selects none
        feats, objectness, box_reg, anchors, proposals = self._rpn_forward(
            images, image_sizes, train=True, select=not s.rpn_only
        )
        gt_boxes = batch["gt_boxes"].to(torch.float32)
        gt_labels = batch["gt_labels"]
        gt_valid = batch["gt_valid"].to(torch.bool)
        losses: Dict[str, torch.Tensor] = {}
        info: Dict[str, torch.Tensor] = {}

        if not s.rpn_dont_train:
            obj_loss, rpn_box_loss = rpn_loss(
                anchors,
                anchor_visibility(anchors, image_sizes, s.straddle_thresh),
                objectness.to(torch.float32),
                box_reg.to(torch.float32),
                gt_boxes,
                gt_valid,
                draws.rpn_sampler,
                generator,
                s.rpn_fg_iou,
                s.rpn_bg_iou,
                s.rpn_batch_per_image,
                s.rpn_positive_fraction,
            )
            losses["loss_objectness"] = obj_loss
            losses["loss_rpn_box_reg"] = rpn_box_loss

        if s.rpn_only:
            return RCNNTrainOutput(losses, info)
        if s.wsddn:
            losses["loss_classifier"] = self._wsddn_loss(feats, proposals, batch)
            return RCNNTrainOutput(losses, info)

        # add_gt_proposals (rpn/inference.py:53-74)
        sampled = subsample_rois(
            torch.cat([proposals.boxes, gt_boxes], dim=1),
            torch.cat([proposals.valid, gt_valid], dim=1),
            gt_boxes, gt_labels, gt_valid, draws.gt_sampler, generator,
            s.roi_batch_per_image, s.roi_positive_fraction,
            s.roi_fg_iou, s.roi_bg_iou, s.reg_weights,
        )
        x = self.extract(feats, sampled.boxes)
        logits, deltas, _ = self.box_outputs(x, class_embeddings)
        losses["loss_classifier"], losses["loss_box_reg"] = box_head_loss(
            logits.to(torch.float32), deltas.to(torch.float32), sampled, s.bg_weight,
            cls_agnostic_bbox_reg=s.cls_agnostic_bbox_reg, sample_weights=pseudo_sample_weights,
        )
        if s.mask_on:
            # the mask head on the positives-first slots (SampledRoIs.head)
            cap = min(s.mask_pos_cap, s.roi_batch_per_image)
            b = images.shape[0]
            x_mask = x.reshape(b, -1, *x.shape[1:])[:, :cap].reshape(-1, *x.shape[1:])
            sampled_mask = sampled.head(cap)
            mask_logits, scale = self.mask_outputs(
                x_mask, compute_uncertain=compute_uncertain, train=True,
                eps=draws.mask_eps, generator=generator,
            )
            losses["loss_mask"] = mask_head_loss(
                mask_logits.to(torch.float32), sampled_mask, batch["gt_masks"], gt_boxes,
                estimator=s.uncertainty_estimator, cls_agnostic_mask=s.cls_agnostic_mask,
            )
            if scale is not None:
                # the mean sigma over the positive mask slots (the JAX
                # code reads the positives of all sampled slots, the same
                # ones whenever the mask slice covers them all)
                pos = (sampled_mask.is_pos & sampled_mask.valid).reshape(-1).to(torch.float32)
                info["avg_uncertain"] = torch.sum(
                    scale[..., 0].to(torch.float32).mean(dim=(1, 2)) * pos
                ) / pos.sum().clamp(min=1.0)
        if s.keypoint_on and "gt_keypoints" in batch:
            # the positives-first slots of the mask head, on the box
            # head's features, against each roi's matched gt keypoints
            cap = min(s.mask_pos_cap, s.roi_batch_per_image)
            b = images.shape[0]
            x_kp = x.reshape(b, -1, *x.shape[1:])[:, :cap].reshape(-1, *x.shape[1:])
            sampled_kp = sampled.head(cap)
            gt_kp = batch["gt_keypoints"].to(torch.float32)  # [B, G, K, 3]
            idx = sampled_kp.matched_gt[..., None, None].expand(-1, -1, *gt_kp.shape[2:])
            kp = torch.gather(gt_kp, 1, idx).reshape(-1, *gt_kp.shape[2:])
            losses["loss_kp"] = keypoint_loss(
                self.keypoint_predictor(x_kp).to(torch.float32), kp, sampled_kp.boxes.reshape(-1, 4),
                (sampled_kp.is_pos & sampled_kp.valid).reshape(-1),
            )
        return RCNNTrainOutput(losses, info)

    def _wsddn_scores(self, feats, proposals):
        """The WSDDN head on every proposal's pooled vector, in float32."""
        b, p = proposals.boxes.shape[:2]
        vec = self.extract(feats, proposals.boxes).mean(dim=(1, 2))
        return self.wsddn_head(vec.to(torch.float32).reshape(b, p, -1), proposals.valid)

    def _wsddn_loss(self, feats, proposals, batch):
        """The image-level BCE on all proposals.  Without ``image_labels``
        the labels are the classes of the image's valid gt boxes (class
        L in column L, the background column 0 cleared)."""
        _, image_scores = self._wsddn_scores(feats, proposals)
        image_labels = batch.get("image_labels")
        if image_labels is None:
            c = image_scores.shape[-1]
            onehot = torch.nn.functional.one_hot(batch["gt_labels"].to(torch.int64).clamp(0, c - 1), c)
            onehot = onehot.to(torch.float32) * batch["gt_valid"].to(torch.float32)[..., None]
            image_labels = onehot.amax(dim=1)
            image_labels[:, 0] = 0.0
        return wsddn_loss(image_scores, image_labels.to(torch.float32), background_weight=self.statics.bg_weight)

    def forward_eval(self, images, image_sizes, class_embeddings=None, gt_eval=None) -> RCNNEvalOutput:
        feats, _, _, _, proposals = self._rpn_forward(images, image_sizes, train=False)
        if self.statics.rpn_only:
            # the proposals themselves, scored by recall
            # (engine/inference.py::evaluate_proposals)
            labels = torch.zeros(proposals.scores.shape, dtype=torch.int32, device=proposals.scores.device)
            return RCNNEvalOutput(Detections(proposals.boxes, proposals.scores, labels, proposals.valid), None)
        override = None
        if gt_eval is not None:
            valid = gt_eval["valid"].to(torch.bool)
            boxes = gt_eval["boxes"].to(torch.float32)
            proposals = RPNProposals(boxes, torch.ones(boxes.shape[:2], device=boxes.device), valid)
            override = torch.where(valid, gt_eval["labels"].to(torch.int64), -1)
        s = self.statics
        if s.wsddn:
            proposal_scores, _ = self._wsddn_scores(feats, proposals)
            dets = wsddn_inference(
                proposal_scores, proposals.boxes, proposals.valid, s.score_thresh, s.nms_thresh,
                s.detections_per_img,
            )
            return RCNNEvalOutput(dets, None)
        out = detect(self, feats, proposals, image_sizes, class_embeddings, override)
        if not s.keypoint_on:
            return out
        boxes = out.detections.boxes
        kp_logits = self.keypoint_predictor(self.extract(feats, boxes))
        xy, scores = keypoint_inference(kp_logits.to(torch.float32), boxes.reshape(-1, 4))
        keypoints = torch.cat([xy, scores[..., None]], dim=-1)
        return out._replace(keypoints=keypoints.reshape(*boxes.shape[:2], *keypoints.shape[1:]))

    def run_teacher_pseudo_branch(self, images, image_sizes, class_embeddings=None) -> TeacherPseudoOutput:
        """The eval-mode box branch on every test-time proposal, unfiltered:
        region embeddings, class logits and the regressed boxes (the
        predictor's last 4 deltas, decoded and clipped).  ``images`` go to
        the trunk as given, as in JAX (no normalization here)."""
        feats, _, _, _, proposals = self._rpn_forward(images, image_sizes, train=False)
        logits, deltas, emb = self.box_outputs(self.extract(feats, proposals.boxes), class_embeddings)
        b, p = proposals.boxes.shape[:2]
        deltas = deltas.to(torch.float32).reshape(b, p, -1)[..., -4:]
        boxes = clip_to_image(decode_boxes(deltas, proposals.boxes, self.statics.reg_weights), image_sizes)
        return TeacherPseudoOutput(
            proposals, emb.to(torch.float32).reshape(b, p, -1), logits.to(torch.float32).reshape(b, p, -1), boxes
        )

    def predict_masks_for_boxes(self, images, image_sizes, boxes) -> torch.Tensor:
        """The mask head's probabilities ``[B, P, M, M]`` (channel 1 of a
        class-specific head, as JAX reads it) on ``boxes`` ``[B, P, 4]``;
        uint8 ``images`` are normalized first."""
        s = self.statics
        feats = self.backbone(device_normalize(images, image_sizes, s.pixel_mean, s.pixel_std, s.to_bgr255))
        x = self.extract(feats, boxes)
        mask_logits, _ = self.mask_outputs(x)
        probs = mask_head_inference(
            mask_logits.to(torch.float32), torch.ones(x.shape[0], dtype=torch.int64, device=x.device),
            s.cls_agnostic_mask,
        )
        return probs.reshape(boxes.shape[0], -1, *probs.shape[-2:])
