"""STGeneralizedRCNN: the student-teacher detector.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/detector/
st_generalized_rcnn.py`` (``STStatics`` :62, ``st_statics_from_cfg``
:74, ``normalize_rows`` :87, ``init_exemplar_table`` :111,
``update_exemplar_table`` :119, ``extract_word_embeddings`` :213,
``combine_embs`` :226, ``_teacher_region_scores`` :292,
``_pseudo_loss_extras`` :241, ``_teacher_masks`` :322,
``generate_pseudo_labels`` :336, ``_student_branch_losses`` :387,
``__call__`` :501, ``forward_eval`` :678).  The paper's comparison
baselines (``baselines.py``) subclass it: they override
``generate_pseudo_labels`` and ``_pseudo_loss_extras``, whose per-target
weights and focal exponent reach the caption branch's box loss.

Training runs two student branches over the whole padded batch, each
masked per image.  The caption branch takes the teacher's pseudo-labels:
the teacher-regressed proposal that best matches each caption noun, its
sigmoid score and the teacher's binarized mask; the student trains on
them against the LVIS table, with its box losses weighted by ``0.01 /
avg_uncertain`` (detached).  The GT branch trains on the detection
annotations against the dataset's class table.  The backbone, the RPN
and the teacher run under ``torch.no_grad()``: their parameters are
frozen, and the JAX module stops the gradient at their outputs.
Eval serves the student RoI heads with the dataset's class table.  The
FPN body (``-FPN``) is the teacher's (``generalized_rcnn.py``): both of
its selectors, the eval selector of the caption branch and of eval and
the train selector of the GT branch, select per level, and the frozen
FPN runs under ``torch.no_grad()`` with the rest of the backbone.  The C5
body (``-C5``) is JAX's: its trunk is built without ``RES5_DILATION``
(``st_generalized_rcnn.py:186-190``), so res5 strides 2 while both RoI
heads dilate it and pool without the prestride.  ``MODEL.KEYPOINT_ON`` and
``MODEL.ROI_BOX_HEAD.WSDDN`` reach no part of this model, as in JAX: it
builds, trains and serves as without them.

The random draws (the RoI sampler's priorities and the mask
uncertainty's normal samples) come from a ``torch.Generator`` or, to
replay another program's draws, from :class:`TrainDraws`.

Two options, off in the shipped configs, run as in JAX:

* ``MODEL.EXEMPLARS_ENABLED``: the exemplar table (the reference's
  ``update_exemplars`` memory) is a dict of ``embs`` ``[1203, emb]``,
  ``quality`` and ``valid`` ``[1203]`` that the caller passes in
  (``exemplars``) and gets back updated in ``info["exemplars"]``.  The
  caption branch updates it from the pseudo-labels (best quality per
  LVIS slot, strictly better than the stored one), then mixes it into
  the LVIS table; the detection branch mixes it into the dataset's
  table through ``batch["class_lvis_ids"]``.  A mixed table detaches its
  base, so only ``lambda_exemplar`` gets a gradient through it.
* ``MODEL.LANGUAGE_BACKBONE.FT_EMB``: with ``lvis_name_ids`` and
  ``lvis_name_mask`` ``[1203, T]`` in the batch, the LVIS table is
  rebuilt from the live word table with autograd, so that the caption
  branch's loss reaches ``bert``; the caption nouns' embeddings stay
  cut, as JAX's ``stop_gradient`` of the pseudo-labels cuts them.
"""

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from ...core.box_coder import decode_boxes
from ...core.boxes import clip_to_image
from ..backbone import device_normalize
from ..language.bert import WordEmbeddingBackbone
from ..roi_heads.box_head import box_head_loss, subsample_rois
from ..roi_heads.bundle import RoIHeadsBundle, compute_dtype, feature_channels
from ..roi_heads.mask_head import mask_head_inference, mask_head_loss
from ..rpn.rpn import RPNHead, RPNProposals, flatten_rpn_outputs
from .generalized_rcnn import (
    AnchorCache,
    RCNNEvalOutput,
    RCNNTrainOutput,
    TrainDraws,
    check_ported,
    detect,
    detector_backbone,
    num_cell_anchors,
    select_proposals,
)
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


def init_exemplar_table(vocab_size: int, emb_dim: int, device=None) -> Dict[str, torch.Tensor]:
    """An empty exemplar table: zero embeddings, quality -inf, no valid
    slot."""
    return {
        "embs": torch.zeros((vocab_size, emb_dim), dtype=torch.float32, device=device),
        "quality": torch.full((vocab_size,), -float("inf"), dtype=torch.float32, device=device),
        "valid": torch.zeros((vocab_size,), dtype=torch.bool, device=device),
    }


@torch.no_grad()
def update_exemplar_table(table, labels, scores, embs, valid) -> Dict[str, torch.Tensor]:
    """Keeps, for each slot, the best-scoring embedding seen: labels
    ``[N]`` (clipped to the table), scores ``[N]``, embs ``[N, d]``
    (row-normalized here), valid ``[N]``.  The batch's best per slot is a
    scatter-max, ties go to the first occurrence (a scatter-min of the
    index), and a slot takes it only when it beats the stored quality.
    Nothing here carries a gradient, as the reference stores detached
    copies."""
    v, n = table["quality"].shape[0], labels.shape[0]
    quality = torch.where(valid, scores.to(torch.float32), torch.full((), -float("inf"), device=scores.device))
    embs = normalize_rows(embs.to(torch.float32))
    slot = labels.to(torch.int64).clamp(0, v - 1)
    best_q = torch.full((v,), -float("inf"), device=quality.device).scatter_reduce(
        0, slot, quality, "amax", include_self=True)
    is_best = (quality == best_q[slot]) & valid
    index = torch.arange(n, device=slot.device)
    order = torch.where(is_best, index, torch.full_like(index, n))
    first = torch.full((v,), n, dtype=torch.int64, device=slot.device).scatter_reduce(
        0, slot, order, "amin", include_self=True)
    improve = (best_q > table["quality"]) & (first < n)
    return {
        "embs": torch.where(improve[:, None], embs[first.clamp(0, n - 1)], table["embs"]),
        "quality": torch.where(improve, best_q, table["quality"]),
        "valid": table["valid"] | improve,
    }


class PseudoLabels(NamedTuple):
    boxes: torch.Tensor  # [B, W, 4] teacher-regressed
    scores: torch.Tensor  # [B, W] sigmoid of the best region score
    valid: torch.Tensor  # [B, W] bool
    labels: torch.Tensor  # [B, W] int64 LVIS ids of the nouns
    masks: Optional[torch.Tensor]  # [B, W, M, M] binarized teacher masks
    weights: Optional[torch.Tensor] = None  # [B, W] per-target loss weights (SoftTeacher)
    embs: Optional[torch.Tensor] = None  # [B, W, emb] the chosen regions' embeddings (the exemplar table's)


class STGeneralizedRCNN(nn.Module):
    def __init__(self, statics: STStatics):
        super().__init__()
        s = statics.base
        check_ported(s)
        if not s.embedding_based:
            raise ValueError(
                "the student-teacher model scores regions against caption nouns: "
                "it needs MODEL.ROI_BOX_HEAD.EMBEDDING_BASED True"
            )
        self.statics = statics
        # JAX's student-teacher model builds a C5 trunk without
        # RES5_DILATION (st_generalized_rcnn.py:186-190); its RoI heads
        # still run res5 dilated and pool without the prestride
        self.backbone = detector_backbone(s, dilate_res5=False)
        self.rpn_head = RPNHead(
            s.backbone_out_channels, num_cell_anchors(s), compute_dtype(s), feature_channels(s)
        )
        self.teacher = RoIHeadsBundle(s, uncertainty=False)
        self.student = RoIHeadsBundle(s, uncertainty=statics.uncertainty)
        self.bert = WordEmbeddingBackbone(statics.vocab_size, s.emb_dim)
        self.lambda_exemplar = nn.Parameter(torch.zeros(1))
        self.anchors = AnchorCache(s)

    def combine_embs(self, embs: torch.Tensor, exemplar_embs=None, exemplar_valid=None) -> torch.Tensor:
        """Row-normalizes the table, after adding ``lambda_exemplar`` times
        the valid exemplar rows to its detached base when exemplars are
        given."""
        if exemplar_embs is None:
            return normalize_rows(embs)
        mixed = embs.detach() + self.lambda_exemplar * exemplar_embs * exemplar_valid.to(embs.dtype)[:, None]
        return normalize_rows(mixed)

    def extract_word_embeddings(self, token_ids, token_mask):
        """Mean word embedding over the real wordpieces, L2-normalized:
        ``[..., T]`` ids and mask -> ``[..., emb_dim]``."""
        emb = self.bert(token_ids)
        m = token_mask.to(torch.float32)[..., None]
        mean = torch.sum(emb * m, dim=-2) / torch.sum(m, dim=-2).clamp(min=1e-6)
        return normalize_rows(mean)

    def forward(
        self,
        images: torch.Tensor,
        image_sizes: torch.Tensor,
        class_embeddings: torch.Tensor,
        train: bool = False,
        batch: Optional[Dict[str, torch.Tensor]] = None,
        lvis_class_embeddings: Optional[torch.Tensor] = None,
        draws: TrainDraws = TrainDraws(),
        generator: Optional[torch.Generator] = None,
        exemplars: Optional[Dict[str, torch.Tensor]] = None,
    ):
        """images ``[B, H, W, 3]`` uint8 (or already-normalized float);
        image_sizes ``[B, 2]`` (h, w); class_embeddings ``[C, emb_dim]``
        with the background row 0.

        Eval returns :class:`RCNNEvalOutput`.  Training (``train=True``)
        returns :class:`RCNNTrainOutput` and reads ``batch``: ``cap_mask``
        and ``det_mask`` ``[B]`` (the images of each branch);
        ``cap_tok_ids``, ``cap_tok_mask`` ``[B, W, T]``, ``cap_word_valid``
        and ``cap_labels`` ``[B, W]`` (caption nouns); ``gt_boxes`` ``[B,
        G, 4]``, ``gt_labels``, ``gt_valid`` ``[B, G]`` and ``gt_masks``
        ``[B, G, Mr, Mr]``.  ``lvis_class_embeddings`` ``[1203, emb_dim]``
        is the caption branch's table, which ``lvis_name_ids`` and
        ``lvis_name_mask`` in ``batch`` replace (``FT_EMB``);
        ``class_lvis_ids`` ``[C]`` maps the dataset's classes to LVIS slots
        (-1: none) for the exemplar table ``exemplars`` (see the module
        docstring)."""
        sb = self.statics.base
        if train:
            self._check_trainable(batch)
        x = device_normalize(
            images, image_sizes, sb.pixel_mean, sb.pixel_std, sb.to_bgr255
        )
        if not train:
            return self.forward_eval(self.backbone(x), image_sizes, class_embeddings)
        if "lvis_name_ids" in batch:
            # FT_EMB: from the live word table, with autograd
            lvis_class_embeddings = self.extract_word_embeddings(batch["lvis_name_ids"], batch["lvis_name_mask"])
        if lvis_class_embeddings is None:
            raise ValueError("STGeneralizedRCNN training needs lvis_class_embeddings or batch['lvis_name_ids']")
        with torch.no_grad():
            feats = self.backbone(x)
            obj_l, reg_l = self.rpn_head(feats)
            objectness, box_reg = flatten_rpn_outputs(obj_l, reg_l)
        return self.forward_train(
            feats, objectness, box_reg, image_sizes, batch, class_embeddings,
            lvis_class_embeddings, draws, generator, exemplars,
        )

    def _check_trainable(self, batch):
        if batch is None:
            raise ValueError("STGeneralizedRCNN training needs `batch`")

    def _proposals(self, feats, objectness, box_reg, image_sizes, train_selector):
        return select_proposals(
            self.statics.base, self.anchors(feats)[0], objectness, box_reg, image_sizes,
            train_selector,
        )

    # ------------------------------------------------------------------
    def _teacher_region_scores(self, feats, proposals, image_sizes, cap_tok_ids, cap_tok_mask):
        """The teacher's region embeddings ``[B, P, emb]``, its regressed
        boxes and the region x caption-noun similarity ``[B, P, W]``."""
        sb = self.statics.base
        b, p = proposals.boxes.shape[:2]
        x = self.teacher.extract(feats, proposals.boxes)
        _, deltas, emb = self.teacher.box_outputs(
            x, torch.zeros((1, sb.emb_dim), device=x.device)
        )
        emb = emb.to(torch.float32).reshape(b, p, -1)
        deltas = deltas.to(torch.float32).reshape(b, p, -1)[..., -4:]
        reg_boxes = clip_to_image(
            decode_boxes(deltas, proposals.boxes, sb.reg_weights), image_sizes
        )
        noun_embs = self.extract_word_embeddings(cap_tok_ids, cap_tok_mask)
        return emb, reg_boxes, torch.einsum("bpd,bwd->bpw", emb, noun_embs)

    def _teacher_masks(self, feats, pseudo_boxes):
        """The teacher's masks on the chosen boxes, binarized at 0.5."""
        b = pseudo_boxes.shape[0]
        x2 = self.teacher.extract(feats, pseudo_boxes)
        mask_logits, _ = self.teacher.mask_outputs(x2)
        # the class-specific head's channel 1, as the JAX function reads it
        probs = mask_head_inference(
            mask_logits.to(torch.float32), torch.ones(x2.shape[0], dtype=torch.int64, device=x2.device),
            self.statics.base.cls_agnostic_mask,
        )
        m = probs.shape[-1]
        return (probs.reshape(b, -1, m, m) >= 0.5).to(torch.float32)

    @torch.no_grad()
    def generate_pseudo_labels(
        self, feats, proposals, image_sizes, cap_tok_ids, cap_tok_mask,
        cap_word_valid, cap_labels,
    ) -> PseudoLabels:
        """Per caption noun, the valid proposal of the highest region
        score (the first among ties); a noun whose image has no valid
        proposal is invalid."""
        emb, reg_boxes, region_scores = self._teacher_region_scores(
            feats, proposals, image_sizes, cap_tok_ids, cap_tok_mask
        )
        region_scores = torch.where(
            proposals.valid[:, :, None], region_scores,
            torch.full((), -float("inf"), device=region_scores.device),
        )
        aligned_scores, aligned_idx = region_scores.max(dim=1)  # [B, W]
        pseudo_boxes = torch.gather(reg_boxes, 1, aligned_idx[..., None].expand(-1, -1, 4))
        masks = self._teacher_masks(feats, pseudo_boxes) if self.statics.base.mask_on else None
        return PseudoLabels(
            boxes=pseudo_boxes,
            scores=torch.sigmoid(aligned_scores),
            valid=cap_word_valid.to(torch.bool) & torch.isfinite(aligned_scores),
            labels=cap_labels.to(torch.int64),
            masks=masks,
            embs=torch.gather(emb, 1, aligned_idx[..., None].expand(-1, -1, emb.shape[-1])),
        )

    def _pseudo_loss_extras(self, pseudo: PseudoLabels) -> Dict:
        """Keyword arguments of the caption branch's
        :meth:`_student_branch_losses`; the baselines override it."""
        return {}

    # ------------------------------------------------------------------
    def _student_branch_losses(
        self, feats, proposals: RPNProposals, gt_boxes, gt_labels, gt_valid,
        gt_masks, gt_mask_boxes, class_embeddings, image_mask,
        compute_uncertain, append_gt, rand=None, eps=None, generator=None,
        sample_weight_table=None, focal_gamma=None,
    ):
        """One student branch: sample rois, then the box and mask losses,
        over the images of ``image_mask`` only.  ``sample_weight_table``
        ``[B, G]``: each positive roi's classification weight is its
        matched target's (negatives 1); ``focal_gamma``: the focal
        reweighting of the classification loss.  Returns
        (classification, box, mask, avg_uncertain)."""
        sb = self.statics.base
        pvalid = proposals.valid & image_mask[:, None]
        gvalid = gt_valid & image_mask[:, None]
        if append_gt:
            # the train selector's add_gt_proposals; the caption branch's
            # eval selector appends no targets
            all_boxes = torch.cat([proposals.boxes, gt_boxes], dim=1)
            all_valid = torch.cat([pvalid, gvalid], dim=1)
        else:
            all_boxes, all_valid = proposals.boxes, pvalid
        sampled = subsample_rois(
            all_boxes, all_valid, gt_boxes, gt_labels, gvalid, rand, generator,
            sb.roi_batch_per_image, sb.roi_positive_fraction,
            sb.roi_fg_iou, sb.roi_bg_iou, sb.reg_weights,
        )
        sampled = sampled._replace(
            valid=sampled.valid & image_mask[:, None],
            is_pos=sampled.is_pos & image_mask[:, None],
        )
        x = self.student.extract(feats, sampled.boxes)
        logits, deltas, _ = self.student.box_outputs(x, class_embeddings)
        sample_weights = None
        if sample_weight_table is not None:
            g = sample_weight_table.shape[1]
            per_roi = torch.gather(sample_weight_table, 1, sampled.matched_gt.clamp(0, g - 1))
            sample_weights = torch.where(sampled.is_pos, per_roi, torch.ones_like(per_roi))
        cls_loss, box_loss = box_head_loss(
            logits.to(torch.float32), deltas.to(torch.float32), sampled, sb.bg_weight,
            cls_agnostic_bbox_reg=sb.cls_agnostic_bbox_reg, sample_weights=sample_weights,
            focal_gamma=focal_gamma,
        )
        mask_loss = torch.zeros((), device=x.device)
        avg_uncertain = torch.ones((), device=x.device)
        if sb.mask_on:
            # the positives-first slots (SampledRoIs.head)
            cap = min(sb.mask_pos_cap, sb.roi_batch_per_image)
            b = feats[0].shape[0]
            x_mask = x.reshape(b, -1, *x.shape[1:])[:, :cap].reshape(-1, *x.shape[1:])
            sampled_mask = sampled.head(cap)
            mask_logits, scale = self.student.mask_outputs(
                x_mask, compute_uncertain=compute_uncertain, train=True,
                eps=eps, generator=generator,
            )
            mask_loss = mask_head_loss(
                mask_logits.to(torch.float32), sampled_mask, gt_masks, gt_mask_boxes,
                estimator=sb.uncertainty_estimator, cls_agnostic_mask=sb.cls_agnostic_mask,
            )
            if scale is not None:
                pos = (sampled_mask.is_pos & sampled_mask.valid).reshape(-1).to(torch.float32)
                avg_uncertain = torch.sum(
                    scale[..., 0].to(torch.float32).mean(dim=(1, 2)) * pos
                ) / pos.sum().clamp(min=1.0)
        return cls_loss, box_loss, mask_loss, avg_uncertain

    def forward_train(
        self, feats, objectness, box_reg, image_sizes, batch, class_embeddings,
        lvis_class_embeddings, draws: TrainDraws = TrainDraws(),
        generator: Optional[torch.Generator] = None, exemplars: Optional[Dict[str, torch.Tensor]] = None,
    ) -> RCNNTrainOutput:
        s = self.statics
        losses: Dict[str, torch.Tensor] = {}
        info: Dict[str, torch.Tensor] = {}
        cap_mask = batch["cap_mask"].to(torch.bool)
        det_mask = batch["det_mask"].to(torch.bool)

        # ---- caption branch: teacher pseudo-labels -> student ----------
        eval_proposals = self._proposals(feats, objectness, box_reg, image_sizes, False)
        pseudo = self.generate_pseudo_labels(
            feats, eval_proposals, image_sizes, batch["cap_tok_ids"],
            batch["cap_tok_mask"], batch["cap_word_valid"], batch["cap_labels"],
        )
        masks = pseudo.masks
        if masks is None:
            masks = torch.zeros((feats[0].shape[0], 1, 1, 1), device=feats[0].device)
        use_exemplars = s.exemplars_enabled and exemplars is not None
        if use_exemplars:
            # update first, then mix the updated table (one LVIS slot a row)
            exemplars = update_exemplar_table(
                exemplars, pseudo.labels.reshape(-1), pseudo.scores.reshape(-1),
                pseudo.embs.reshape(-1, pseudo.embs.shape[-1]), (pseudo.valid & cap_mask[:, None]).reshape(-1),
            )
            info["exemplars"] = exemplars
            cap_embs = self.combine_embs(lvis_class_embeddings, exemplars["embs"], exemplars["valid"])
        else:
            cap_embs = self.combine_embs(lvis_class_embeddings)
        cls_p, box_p, mask_p, avg_unc = self._student_branch_losses(
            feats, eval_proposals, pseudo.boxes, pseudo.labels, pseudo.valid,
            masks, pseudo.boxes, cap_embs,
            cap_mask, compute_uncertain=s.uncertainty, append_gt=False,
            rand=draws.pseudo_sampler, eps=draws.mask_eps, generator=generator,
            **self._pseudo_loss_extras(pseudo),
        )
        info["avg_uncertain"] = avg_unc
        if s.uncertainty and s.reweight:
            # 0.01 / avg_uncertain, detached; a branch without a valid
            # pseudo sample has avg_uncertain 0 and weight 0 (not inf)
            safe = avg_unc.detach()
            lam = torch.where(
                safe > 0, torch.full_like(safe, 0.01) / safe.clamp(min=1e-20),
                torch.zeros_like(safe),
            )
            info["adaptive_lamb"] = lam
            losses["loss_classifier_pseudo"] = cls_p * lam
            losses["loss_box_reg_pseudo"] = box_p * lam
            losses["loss_mask_pseudo"] = mask_p
        else:
            lam = s.lambda_pseudo_label
            losses["loss_classifier_pseudo"] = cls_p * lam
            losses["loss_box_reg_pseudo"] = box_p * lam
            losses["loss_mask_pseudo"] = mask_p * lam
        if s.no_pseudo_mask:
            losses["loss_mask_pseudo"] = losses["loss_mask_pseudo"] * 0.0

        # ---- detection branch: GT supervision ---------------------------
        train_proposals = self._proposals(feats, objectness, box_reg, image_sizes, True)
        gt_boxes = batch["gt_boxes"].to(torch.float32)
        det_lvis_ids = batch.get("class_lvis_ids")
        if use_exemplars and det_lvis_ids is not None:
            # the dataset's classes mixed by name: a class that is no LVIS
            # noun (-1, the background too) stays as it is
            safe = det_lvis_ids.to(torch.int64).clamp(min=0)
            det_embs = self.combine_embs(
                class_embeddings, exemplars["embs"][safe], exemplars["valid"][safe] & (det_lvis_ids >= 0))
        else:
            det_embs = self.combine_embs(class_embeddings)
        cls_g, box_g, mask_g, _ = self._student_branch_losses(
            feats, train_proposals, gt_boxes, batch["gt_labels"],
            batch["gt_valid"].to(torch.bool), batch["gt_masks"], gt_boxes,
            det_embs, det_mask,
            compute_uncertain=False, append_gt=True, rand=draws.gt_sampler,
            generator=generator,
        )
        losses["loss_classifier"] = cls_g
        losses["loss_box_reg"] = box_g
        losses["loss_mask"] = mask_g
        return RCNNTrainOutput(losses, info)

    def forward_eval(self, feats, image_sizes, class_embeddings) -> RCNNEvalOutput:
        """The student's RoI heads against the normalized class table."""
        obj_l, reg_l = self.rpn_head(feats)
        objectness, box_reg = flatten_rpn_outputs(obj_l, reg_l)
        proposals = self._proposals(feats, objectness, box_reg, image_sizes, False)
        return detect(self.student, feats, proposals, image_sizes, self.combine_embs(class_embeddings))
