"""Dataset registry: the port's counterpart of ``cvpr22_cross_modal_
pseudo_labeling_tpu/data/datasets/__init__.py``.  Every dataset of the
JAX package is ported except ``PascalVOCDataset`` and
``CityScapesDataset``: their classes have no embedding table, so they
wait with the class-specific heads (ROADMAP.md queue A item 6), and
``data/build.py`` refuses their catalog entries."""

from .coco import COCODataset
from .coco_cap_det import COCOCapDetDataset
from .coco_captions import COCOCaptionsDataset
from .concat import ConcatDataset
from .conceptual import ConCapDetDataset, ConceptualOpenImagesDetDataset
from .list_dataset import ConceptualCaptionsDataset, ListDataset
from .openimages import OpenImagesDataset

__all__ = [
    "COCODataset",
    "COCOCapDetDataset",
    "COCOCaptionsDataset",
    "ConcatDataset",
    "ConCapDetDataset",
    "ConceptualOpenImagesDetDataset",
    "OpenImagesDataset",
    "ListDataset",
    "ConceptualCaptionsDataset",
]
