"""RetinaNet with the ``GeneralizedRCNN`` call surface.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/detector/
retinanet.py::RetinaNetDetector`` (:18).  The reference reaches RetinaNet
through ``MODEL.RETINANET_ON`` inside its GeneralizedRCNN skeleton; this
adapter gives :class:`~..rpn.retinanet.RetinaNet` the call surface of
:class:`.generalized_rcnn.GeneralizedRCNN`, so that ``Trainer``,
``Predictor``, ``compute_on_dataset`` and both entry points drive it
unchanged.  The class table is not read (a fixed-vocabulary classifier),
nor are a training forward's draws: the loss samples nothing.  Training
returns the two losses and no info; eval the detections and no masks.
"""

from typing import Dict, Optional

import torch
from torch import nn

from ..rpn.retinanet import RetinaNet, RetinaNetStatics
from .generalized_rcnn import RCNNEvalOutput, RCNNTrainOutput


class RetinaNetDetector(nn.Module):
    def __init__(self, statics: RetinaNetStatics, backbone_depth: str = "R-50", dtype=torch.float32,
                 **net_kwargs):
        super().__init__()
        self.statics = statics
        self.net = RetinaNet(statics, backbone_depth=backbone_depth, dtype=dtype, **net_kwargs)

    def forward(
        self,
        images: torch.Tensor,
        image_sizes: torch.Tensor,
        class_embeddings: Optional[torch.Tensor] = None,
        train: bool = False,
        batch: Optional[Dict[str, torch.Tensor]] = None,
        **unused,
    ):
        """As ``GeneralizedRCNN.forward``: eval returns
        :class:`RCNNEvalOutput` (``mask_probs`` None); training reads
        ``gt_boxes``, ``gt_labels`` and ``gt_valid`` from ``batch`` and
        returns :class:`RCNNTrainOutput`.  ``class_embeddings`` and the
        other keywords of the ``GeneralizedRCNN`` surface (``draws``,
        ``generator``, ``compute_uncertain``) are taken and not read."""
        if gt_eval := unused.get("gt_eval"):
            raise ValueError(f"RetinaNet scores no given boxes (gt_eval {sorted(gt_eval)})")
        if not train:
            return RCNNEvalOutput(self.net(images, image_sizes, train=False), None)
        if batch is None:
            raise ValueError("RetinaNet training needs `batch`")
        return RCNNTrainOutput(self.net(images, image_sizes, batch, train=True), {})
