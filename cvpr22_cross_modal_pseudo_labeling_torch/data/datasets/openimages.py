"""OpenImages dataset (COCO-converted JSON).

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
datasets/openimages.py``.

Re-design of reference data/datasets/openimages.py:80-345:
  * consumes the COCO-format JSON produced by the converter
    (preprocess/openimages), including the zero-shot seen/unseen
    ``split`` tags and per-category embeddings;
  * repeat-factor sampling weights (t = 0.1 category-frequency
    rebalancing, openimages.py:154-234) exposed as ``repeat_factors``
    for the sampler (computed on the fly, no pickle cache needed — it's
    one pass over annotations);
  * per-instance masks loaded from ``iseg_file_name`` PNGs when present
    (openimages.py:264-295), else from COCO segmentation fields;
  * image-level verified labels CSV (openimages.py:236-241,316-325) ->
    ``imagelevel`` dict used by the OpenImages evaluation protocol.
"""

import csv
import math
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from ...utils.rle import encode_mask
from .coco import COCODataset


class OpenImagesDataset(COCODataset):
    def __init__(
        self,
        ann_file: str,
        root: str,
        remove_images_without_annotations: bool,
        transforms=None,
        extra_args: Optional[dict] = None,
        imagelevel_csv: Optional[str] = None,
        repeat_factor_t: float = 0.1,
    ):
        super().__init__(
            ann_file,
            root,
            remove_images_without_annotations,
            transforms,
            extra_args,
        )
        self.mask_root = os.path.join(os.path.dirname(root or "."), "masks")
        self.repeat_factors = self._compute_repeat_factors(repeat_factor_t)
        self.imagelevel: Dict[int, List[int]] = {}
        if imagelevel_csv and os.path.exists(imagelevel_csv):
            self._load_imagelevel(imagelevel_csv)

    def _compute_repeat_factors(self, t: float) -> np.ndarray:
        """LVIS-style repeat factors (openimages.py:154-234): per
        category, f_c = image frequency; r_c = max(1, sqrt(t / f_c));
        per image, r_i = max over its categories."""
        n = len(self.ids)
        cat_images = defaultdict(set)
        for idx, img_id in enumerate(self.ids):
            for a in self.coco.load_anns_for_image(img_id):
                cat_images[a["category_id"]].add(idx)
        cat_repeat = {
            c: max(1.0, math.sqrt(t / (len(imgs) / max(n, 1))))
            for c, imgs in cat_images.items()
        }
        factors = np.ones(n, np.float64)
        for c, imgs in cat_images.items():
            for i in imgs:
                factors[i] = max(factors[i], cat_repeat[c])
        return factors

    def _load_imagelevel(self, csv_path: str):
        mid_to_cid = {
            c.get("freebase_id", c.get("mid", "")): cid
            for cid, c in self.coco.cats.items()
        }
        img_by_name = {}
        for img_id, info in self.coco.imgs.items():
            stem = os.path.splitext(os.path.basename(info["file_name"]))[0]
            img_by_name[stem] = img_id
        with open(csv_path) as f:
            for row in csv.DictReader(f):
                name = row.get("ImageID")
                mid = row.get("LabelName")
                if name in img_by_name and mid in mid_to_cid:
                    self.imagelevel.setdefault(img_by_name[name], []).append(
                        mid_to_cid[mid]
                    )

    def _segmentation_for_ann(self, ann: dict):
        """Per-instance PNG mask if the converter recorded one
        (openimages.py:264-295), else the inline COCO segmentation."""
        png = ann.get("iseg_file_name")
        if png:
            path = os.path.join(self.mask_root, png)
            if os.path.exists(path):
                with Image.open(path) as m:
                    arr = (np.asarray(m) > 127).astype(np.uint8)
                return encode_mask(arr)
        return ann.get("segmentation")
