"""Dataset registry: the port's counterpart of ``cvpr22_cross_modal_
pseudo_labeling_tpu/data/datasets/__init__.py``, every dataset of the
JAX package.  ``PascalVOCDataset`` and ``CityScapesDataset`` have no
class-embedding table: they serve the class-specific detectors."""

from .cityscapes import CityScapesDataset
from .coco import COCODataset
from .coco_cap_det import COCOCapDetDataset
from .coco_captions import COCOCaptionsDataset
from .concat import ConcatDataset
from .conceptual import ConCapDetDataset, ConceptualOpenImagesDetDataset
from .list_dataset import ConceptualCaptionsDataset, ListDataset
from .openimages import OpenImagesDataset
from .voc import PascalVOCDataset

__all__ = [
    "CityScapesDataset",
    "COCODataset",
    "COCOCapDetDataset",
    "COCOCaptionsDataset",
    "ConcatDataset",
    "ConCapDetDataset",
    "ConceptualOpenImagesDetDataset",
    "OpenImagesDataset",
    "ListDataset",
    "ConceptualCaptionsDataset",
    "PascalVOCDataset",
]
