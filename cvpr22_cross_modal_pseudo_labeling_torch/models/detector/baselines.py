"""The paper's comparison baselines.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/detector/
baselines.py``:

* ``SoftTeacherRCNN`` (``SoftTeacher``): the pseudo-labels are the two
  most confident teacher regions of each image, a region's confidence
  being the largest of its softmax over the caption's nouns; each pseudo
  target's weight, the sigmoid of its confidence, scales the
  classification loss of the rois matched to it.
* ``UnbiasedTeacherRCNN`` (``UnbiasedTeacher``): the same pseudo-labels;
  the caption branch's classification loss gets the focal factor
  ``(1 - exp(-w CE))^1.5``, detached.
* ``SBBaseline``, ``OMPBaseline`` and ``BARPNBaseline`` (``SBBaseline``,
  ``OMP``, ``BA_RPN``): ``GeneralizedRCNN`` as it is.

A pseudo-label's class is the LVIS id (``cap_labels``) of the chosen
noun, as in JAX.
"""

from typing import Dict

import torch

from ..rpn.rpn import top_k
from .generalized_rcnn import GeneralizedRCNN
from .st_generalized_rcnn import PseudoLabels, STGeneralizedRCNN


class _TopKTeacherRCNN(STGeneralizedRCNN):
    """The top-k confident-region pseudo-labels of both teachers."""

    top_k = 2

    @torch.no_grad()
    def generate_pseudo_labels(
        self, feats, proposals, image_sizes, cap_tok_ids, cap_tok_mask,
        cap_word_valid, cap_labels,
    ) -> PseudoLabels:
        """Per image, the ``top_k`` valid proposals of the highest
        confidence (the first among ties), each labelled with its most
        likely noun (the first among ties).  A pseudo-label is invalid
        when fewer proposals are valid, or when the caption has no
        noun."""
        reg_boxes, region_scores = self._teacher_region_scores(
            feats, proposals, image_sizes, cap_tok_ids, cap_tok_mask
        )
        word_valid = cap_word_valid.to(torch.bool)[:, None, :]
        neg_inf = torch.full((), -float("inf"), device=region_scores.device)
        prop = torch.softmax(torch.where(word_valid, region_scores, neg_inf), dim=-1)
        # a caption without a noun gives NaN rows, zeroed here as in JAX
        prop = torch.where(word_valid, prop, torch.zeros((), device=prop.device))
        vs, word_idx = prop.max(dim=-1)  # [B, P]
        vs = torch.where(proposals.valid, vs, neg_inf)
        top_vs, top_idx = top_k(vs, self.top_k)  # [B, k]
        boxes = torch.gather(reg_boxes, 1, top_idx[..., None].expand(-1, -1, 4))
        words = torch.gather(word_idx, 1, top_idx)
        scores = torch.sigmoid(top_vs)
        valid = torch.isfinite(top_vs) & cap_word_valid.to(torch.bool).any(dim=1, keepdim=True)
        masks = self._teacher_masks(feats, boxes) if self.statics.base.mask_on else None
        return PseudoLabels(
            boxes=boxes,
            scores=scores,
            valid=valid,
            labels=torch.gather(cap_labels.to(torch.int64), 1, words),
            masks=masks,
            weights=scores,
        )


class SoftTeacherRCNN(_TopKTeacherRCNN):
    def _pseudo_loss_extras(self, pseudo: PseudoLabels) -> Dict:
        return {"sample_weight_table": pseudo.weights}


class UnbiasedTeacherRCNN(_TopKTeacherRCNN):
    focal_gamma = 1.5

    def _pseudo_loss_extras(self, pseudo: PseudoLabels) -> Dict:
        return {"focal_gamma": self.focal_gamma}


class SBBaseline(GeneralizedRCNN):
    pass


class OMPBaseline(GeneralizedRCNN):
    pass


class BARPNBaseline(GeneralizedRCNN):
    pass
