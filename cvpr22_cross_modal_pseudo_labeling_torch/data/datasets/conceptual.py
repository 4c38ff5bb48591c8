"""Conceptual Captions datasets.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
datasets/conceptual.py``, with one divergence kept on purpose: a caption
image decodes to uint8 (``utils/native_image.py::load_image_rgb``, as
``COCODataset`` decodes), where JAX's decodes to float32 in 0..1.  A
batch of the mixture then holds uint8 images only, and
``INPUT.DEVICE_NORMALIZE`` normalizes every row of it on the device.
In JAX the float caption rows make the whole batch float32, which the
device normalization passes through, so its detection rows reach the
trunk as raw RGB (ROADMAP.md section C).

Re-designs of:
  * ConCapDetDataset (reference data/datasets/conceptual_cap_det.py:
    caption-only images with a dummy box target, ``is_det='No'``,
    ``nn_caption`` from the LVIS parser);
  * ConceptualOpenImagesDetDataset
    (data/datasets/conceptual_openimages_det.py:15-96: mixes an
    OpenImages detection dataset and a Conceptual Captions caption
    dataset through one global index, repeating the smaller detection
    set ``len(concap) // len(oi)`` times and permuting).

The caption index/meta format follows the reference's preprocess stage
(preprocess/conceptual): an index JSON mapping ids to image files and a
caption JSON/JSONL with one caption per id.
"""

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ...utils.native_image import load_image_rgb
from ..parser import get_parser
from ..rng import visit_rng


class ConCapDetDataset:
    def __init__(
        self,
        index_file: str,
        root: str,
        remove_images_without_annotations: bool = False,
        transforms=None,
        extra_args: Optional[dict] = None,
    ):
        with open(index_file) as f:
            index = json.load(f)
        # index: list of {id, file_name, caption}
        self.items: List[dict] = (
            index["images"] if isinstance(index, dict) else index
        )
        self.root = root
        self._transforms = transforms
        parser = get_parser()
        for it in self.items:
            nns, ids = parser.parse(it.get("caption", ""))
            it["_nns"], it["_ids"] = nns, ids

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
        h, w = image.shape[:2]
        sample = {
            "image": image,
            # dummy 1-box target (conceptual_cap_det.py:50-70)
            "boxes": np.asarray(
                [[0.0, 0.0, w - 1.0, h - 1.0]], np.float32
            ),
            "labels": np.zeros((1,), np.int64),
            "gt_masks": np.zeros((1, 28, 28), np.float32),
            "image_id": it.get("id", index),
            "caption": it.get("caption", ""),
            "nn_caption": "/".join(it["_nns"]),
            "ids_cap": list(it["_ids"]),
            "is_det": "No",
        }
        if self._transforms is not None:
            rng = visit_rng(index)
            sample = self._transforms(sample, rng)
        return sample


class ConceptualOpenImagesDetDataset:
    """Balanced mixture by global id: OpenImages (det) repeated to match
    Conceptual Captions (cap), then permuted
    (conceptual_openimages_det.py:43-53)."""

    def __init__(self, det_dataset, cap_dataset, seed: int = 0):
        self.det = det_dataset
        self.cap = cap_dataset
        n_det, n_cap = len(det_dataset), len(cap_dataset)
        repeat = max(n_cap // max(n_det, 1), 1)
        ids = [("det", i) for _ in range(repeat) for i in range(n_det)]
        ids += [("cap", i) for i in range(n_cap)]
        rng = np.random.RandomState(seed)
        self.index = [ids[i] for i in rng.permutation(len(ids))]
        # expose the detection dataset's class metadata
        for attr in (
            "class_emb_mtx",
            "class_names",
            "class_splits",
            "json_category_id_to_contiguous_id",
            "contiguous_category_id_to_json_id",
        ):
            if hasattr(det_dataset, attr):
                setattr(self, attr, getattr(det_dataset, attr))

    def __len__(self):
        return len(self.index)

    def get_img_info(self, index: int) -> dict:
        kind, i = self.index[index]
        return (self.det if kind == "det" else self.cap).get_img_info(i)

    def __getitem__(self, index: int) -> Dict:
        kind, i = self.index[index]
        return (self.det if kind == "det" else self.cap)[i]
