"""COCO captions dataset for MMSS pretraining.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
datasets/coco_captions.py``.

Re-design of reference data/datasets/coco_captions.py:7-83.  Note the
deliberate fork behavior (SURVEY.md 2.10 item 3): the sample's text is
NOT the raw caption but the unique LVIS noun phrases parsed from all of
the image's captions, joined into one string — grounding trains over
noun tokens.  Parsing is precomputed at construction.
"""

import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from ..coco_index import CocoIndex
from ..parser import get_parser
from ..rng import visit_rng


class COCOCaptionsDataset:
    def __init__(
        self,
        ann_file: str,
        root: str,
        remove_images_without_annotations: bool = False,
        transforms=None,
        extra_args: Optional[dict] = None,
    ):
        self.coco = CocoIndex(ann_file)
        self.root = root
        self._transforms = transforms
        self.ids = self.coco.get_img_ids()
        self.id_to_img_map = dict(enumerate(self.ids))

        parser = get_parser()
        self.noun_lists: Dict[int, List[str]] = {}
        for img_id in self.ids:
            nouns = []
            for ann in self.coco.load_anns_for_image(img_id):
                nns, _ = parser.parse(ann.get("caption", ""))
                for n in nns:
                    if n not in nouns:
                        nouns.append(n)
            self.noun_lists[img_id] = nouns

    def __len__(self):
        return len(self.ids)

    def get_img_info(self, index: int) -> dict:
        return self.coco.imgs[self.id_to_img_map[index]]

    def __getitem__(self, index: int) -> Dict:
        img_id = self.id_to_img_map[index]
        info = self.coco.imgs[img_id]
        path = os.path.join(self.root, info["file_name"])
        with Image.open(path) as im:
            image = np.asarray(im.convert("RGB"), np.float32) / 255.0
        sample = {
            "image": image,
            "boxes": np.zeros((0, 4), np.float32),
            "labels": np.zeros((0,), np.int64),
            "gt_masks": np.zeros((0, 28, 28), np.float32),
            "image_id": img_id,
            # noun phrases joined: the text the language backbone sees
            "caption": " ".join(self.noun_lists[img_id]),
            "nn_caption": "/".join(self.noun_lists[img_id]),
            "ids_cap": [],
            "is_det": "No",
        }
        if self._transforms is not None:
            rng = visit_rng(index)
            sample = self._transforms(sample, rng)
        return sample
