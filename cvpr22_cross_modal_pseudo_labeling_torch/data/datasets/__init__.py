"""Dataset registry: the port's counterpart of ``cvpr22_cross_modal_
pseudo_labeling_tpu/data/datasets/__init__.py`` lists only the datasets
that are ported.  VOC, Cityscapes, OpenImages, Conceptual and
``ListDataset`` are not (ROADMAP.md queue A); ``data/build.py`` refuses
their catalog entries."""

from .coco import COCODataset
from .coco_cap_det import COCOCapDetDataset
from .coco_captions import COCOCaptionsDataset
from .concat import ConcatDataset

__all__ = [
    "COCODataset",
    "COCOCapDetDataset",
    "COCOCaptionsDataset",
    "ConcatDataset",
]
