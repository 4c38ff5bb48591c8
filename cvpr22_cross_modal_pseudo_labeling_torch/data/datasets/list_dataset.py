"""Simple image-list datasets (reference data/datasets/list_dataset.py
and conceptual_captions.py parity).

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
datasets/list_dataset.py``.

* ListDataset — iterates a plain list of image paths (inference over a
  directory, no annotations).
* ConceptualCaptionsDataset — caption-only view over a Conceptual
  Captions index for MMSS pretraining (the detection-shaped variant
  lives in conceptual.py::ConCapDetDataset).
"""

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ...utils.native_image import load_image_rgb
from ..rng import visit_rng


class ListDataset:
    def __init__(
        self,
        image_paths: List[str],
        transforms=None,
        extra_args: Optional[dict] = None,
    ):
        self.paths = list(image_paths)
        self._transforms = transforms

    def __len__(self):
        return len(self.paths)

    def get_img_info(self, index: int) -> dict:
        from PIL import Image

        with Image.open(self.paths[index]) as im:
            w, h = im.size
        return {
            "id": index,
            "height": h,
            "width": w,
            "file_name": os.path.basename(self.paths[index]),
        }

    def __getitem__(self, index: int) -> Dict:
        image = load_image_rgb(self.paths[index])
        sample = {
            "image": image,
            "boxes": np.zeros((0, 4), np.float32),
            "labels": np.zeros((0,), np.int64),
            "gt_masks": np.zeros((0, 28, 28), np.float32),
            "image_id": index,
            "is_det": "No",
            "caption": "",
            "nn_caption": "",
            "ids_cap": [],
        }
        if self._transforms is not None:
            rng = visit_rng(index)
            sample = self._transforms(sample, rng)
        return sample


class ConceptualCaptionsDataset:
    """Caption-only samples for MMSS pretraining over Conceptual
    Captions (reference conceptual_captions.py)."""

    def __init__(
        self,
        index_file: str,
        root: str,
        transforms=None,
        extra_args: Optional[dict] = None,
    ):
        with open(index_file) as f:
            index = json.load(f)
        self.items = index["images"] if isinstance(index, dict) else index
        self.root = root
        self._transforms = transforms

    def __len__(self):
        return len(self.items)

    def get_img_info(self, index: int) -> dict:
        it = self.items[index]
        return {
            "id": it.get("id", index),
            "height": it.get("height", 0),
            "width": it.get("width", 0),
            "file_name": it["file_name"],
        }

    def __getitem__(self, index: int) -> Dict:
        it = self.items[index]
        image = load_image_rgb(os.path.join(self.root, it["file_name"]))
        sample = {
            "image": image,
            "boxes": np.zeros((0, 4), np.float32),
            "labels": np.zeros((0,), np.int64),
            "gt_masks": np.zeros((0, 28, 28), np.float32),
            "image_id": it.get("id", index),
            "caption": it.get("caption", ""),
            "nn_caption": "",
            "ids_cap": [],
            "is_det": "No",
        }
        if self._transforms is not None:
            rng = visit_rng(index)
            sample = self._transforms(sample, rng)
        return sample
