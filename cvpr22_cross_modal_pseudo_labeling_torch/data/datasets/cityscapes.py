"""Cityscapes instance-segmentation dataset.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
datasets/cityscapes.py`` (``CITYSCAPES_THING_CLASSES`` :24,
``CityScapesDataset`` :30, ``to_coco_index`` :158; reference
data/datasets/cityscapes.py): walks a ``gtFine`` split directory, reads
each ``*_gtFine_polygons.json``, keeps the 8 instance ("thing") classes
(``...group`` labels as their class) whose polygon's box is at least
``min_area``, and gives the common numpy sample schema with 28 x 28
box-local masks.  ``to_coco_index`` is the COCO-format view the
evaluator reads (the reference's ``abs_to_coco.py``), with RLE
segmentations.  Images are decoded to uint8, as every dataset of the
port is (the JAX class gives float images in [0, 1]).  The catalog has
no raw-Cityscapes entry (its ``cityscapes_*_cocostyle`` entries are
``COCODataset``), so ``data/build.py`` builds this class only for a
catalog that names it.
"""

import glob
import json
import os
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from ...core.boxes import TO_REMOVE
from ...utils.rle import encode_mask, polygons_to_mask
from ..coco_index import CocoIndex
from ..rng import visit_rng
from .coco import rasterize_instance_mask

CITYSCAPES_THING_CLASSES = (
    "__background__", "person", "rider", "car", "truck", "bus",
    "train", "motorcycle", "bicycle",
)


class CityScapesDataset:
    def __init__(
        self,
        img_dir: str,
        ann_dir: str,
        split: str = "train",
        transforms=None,
        extra_args: Optional[dict] = None,
        min_area: float = 16.0,
    ):
        self.img_dir = os.path.join(img_dir, split)
        self.ann_dir = os.path.join(ann_dir, split)
        self._transforms = transforms
        self.class_to_ind = {c: i for i, c in enumerate(CITYSCAPES_THING_CLASSES)}
        self.class_names = list(CITYSCAPES_THING_CLASSES)
        self.categories = {i: c for i, c in enumerate(CITYSCAPES_THING_CLASSES) if i > 0}
        self.min_area = min_area
        self.ann_files = sorted(glob.glob(os.path.join(self.ann_dir, "*", "*_polygons.json")))
        self.id_to_img_map = {i: i for i in range(len(self.ann_files))}
        self._parsed: Dict[int, tuple] = {}
        self._coco_index = None

    def __len__(self):
        return len(self.ann_files)

    def _image_path(self, ann_file: str) -> str:
        city = os.path.basename(os.path.dirname(ann_file))
        stem = os.path.basename(ann_file).replace("_gtFine_polygons.json", "_leftImg8bit.png")
        return os.path.join(self.img_dir, city, stem)

    def _parse(self, index: int):
        """(boxes [N, 4], labels [N], polygons, height, width) of the
        image's kept instances, parsed once."""
        out = self._parsed.get(index)
        if out is not None:
            return out
        with open(self.ann_files[index]) as f:
            data = json.load(f)
        boxes, labels, polys = [], [], []
        for obj in data.get("objects", []):
            name = obj.get("label", "")
            if name.endswith("group"):
                name = name[: -len("group")]
            if name not in self.class_to_ind or name == "__background__":
                continue
            pts = np.asarray(obj["polygon"], np.float32)
            x1, y1 = pts.min(axis=0)
            x2, y2 = pts.max(axis=0)
            if (x2 - x1) * (y2 - y1) < self.min_area:
                continue
            boxes.append([x1, y1, x2, y2])
            labels.append(self.class_to_ind[name])
            polys.append([pts.reshape(-1).tolist()])
        out = (
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int64),
            polys,
            data.get("imgHeight", 1024),
            data.get("imgWidth", 2048),
        )
        self._parsed[index] = out
        return out

    def get_img_info(self, index: int) -> dict:
        _, _, _, h, w = self._parse(index)
        return {"id": index, "height": h, "width": w,
                "file_name": os.path.basename(self._image_path(self.ann_files[index]))}

    def raw_sample(self, index: int) -> Dict:
        from ...utils.native_image import load_image_rgb

        boxes, labels, polys, h, w = self._parse(index)
        gt_masks = (
            np.stack([rasterize_instance_mask(p, b, (h, w), 28) for p, b in zip(polys, boxes)])
            if len(boxes) else np.zeros((0, 28, 28), np.float32)
        )
        return {
            "image": load_image_rgb(self._image_path(self.ann_files[index])),
            "boxes": boxes.copy(),
            "labels": labels.copy(),
            "gt_masks": gt_masks,
            "image_id": index,
            "is_det": "Yes",
            "caption": "",
            "nn_caption": "",
            "ids_cap": [],
        }

    def __getitem__(self, index: int) -> Dict:
        sample = self.raw_sample(index)
        if self._transforms is not None:
            sample = self._transforms(sample, visit_rng(index))
        return sample

    @property
    def coco(self) -> CocoIndex:
        if self._coco_index is None:
            self._coco_index = self.to_coco_index()
        return self._coco_index

    def to_coco_index(self) -> CocoIndex:
        """The COCO-format view: xywh boxes with the +1 width, RLE
        segmentations of the polygons at the image's size."""
        images, annotations = [], []
        for idx in range(len(self.ann_files)):
            boxes, labels, polys, h, w = self._parse(idx)
            images.append(self.get_img_info(idx))
            for b, lab, p in zip(boxes, labels, polys):
                annotations.append({
                    "id": len(annotations) + 1,
                    "image_id": idx,
                    "category_id": int(lab),
                    "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0] + TO_REMOVE),
                             float(b[3] - b[1] + TO_REMOVE)],
                    "area": float((b[2] - b[0] + 1) * (b[3] - b[1] + 1)),
                    "iscrowd": 0,
                    "segmentation": encode_mask(polygons_to_mask(p, h, w)),
                })
        index = CocoIndex.__new__(CocoIndex)
        index.dataset = {
            "images": images,
            "annotations": annotations,
            "categories": [{"id": i, "name": n} for i, n in self.categories.items()],
        }
        index.imgs = {im["id"]: im for im in images}
        index.anns = {a["id"]: a for a in annotations}
        index.cats = {c["id"]: c for c in index.dataset["categories"]}
        index.img_to_anns = defaultdict(list)
        for a in annotations:
            index.img_to_anns[a["image_id"]].append(a)
        return index
