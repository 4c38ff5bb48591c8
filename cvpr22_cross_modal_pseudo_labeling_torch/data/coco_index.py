"""Lightweight COCO-format annotation index (pycocotools-free).

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
coco_index.py``.

Parses an instances/captions JSON once and provides the lookups the
datasets and evaluators need (the subset of pycocotools COCO used by the
reference data layer).
"""

import json
from collections import defaultdict
from typing import Dict, List, Optional


class CocoIndex:
    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.dataset = data
        self.imgs: Dict[int, dict] = {
            im["id"]: im for im in data.get("images", [])
        }
        self.anns: Dict[int, dict] = {
            a["id"]: a for a in data.get("annotations", [])
        }
        self.cats: Dict[int, dict] = {
            c["id"]: c for c in data.get("categories", [])
        }
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        for a in data.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs.keys())

    def get_cat_ids(self) -> List[int]:
        return sorted(self.cats.keys())

    def load_anns_for_image(
        self, img_id: int, iscrowd: Optional[bool] = None
    ) -> List[dict]:
        anns = self.img_to_anns.get(img_id, [])
        if iscrowd is None:
            return anns
        return [a for a in anns if bool(a.get("iscrowd", 0)) == iscrowd]
