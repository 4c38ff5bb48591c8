"""Pascal VOC detection dataset.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
datasets/voc.py`` (``VOC_CLASSES`` :15, ``PascalVOCDataset`` :24;
reference data/datasets/voc.py): a ``VOC2007``-layout directory
(``JPEGImages/<id>.jpg``, ``Annotations/<id>.xml``,
``ImageSets/Main/<split>.txt``) into the common numpy sample schema.
The XML boxes are 1-based and become 0-based xyxy; objects marked
``difficult`` drop out of the samples unless ``use_difficult``.  The
``coco`` view keeps every object, the difficult ones as ``iscrowd``,
which ``data/evaluation/voc_eval.py`` ignores in matching.  Images are
decoded to uint8, as every dataset of the port is (the JAX class gives
float images in [0, 1], normalized on the host); a ``raw_sample`` serves
test-time augmentation.  Evaluated with the VOC protocol
(``eval_protocol``).
"""

import os
import xml.etree.ElementTree as ET
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from ..coco_index import CocoIndex
from ..rng import visit_rng

VOC_CLASSES = (
    "__background__", "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor",
)


class PascalVOCDataset:
    eval_protocol = "voc"

    def __init__(
        self,
        data_dir: str,
        split: str,
        use_difficult: bool = False,
        transforms=None,
        extra_args: Optional[dict] = None,
    ):
        self.root = data_dir
        self.image_set = split
        self.keep_difficult = use_difficult
        self._transforms = transforms
        self._img_dir = os.path.join(data_dir, "JPEGImages")
        self._ann_dir = os.path.join(data_dir, "Annotations")
        with open(os.path.join(data_dir, "ImageSets", "Main", f"{split}.txt")) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        # VOC ids are strings, used only as path components; the eval
        # stack reads the integer index
        self.id_to_img_map = {i: i for i in range(len(self.ids))}
        self.class_to_ind = {c: i for i, c in enumerate(VOC_CLASSES)}
        self.class_names = list(VOC_CLASSES)
        self.categories = {i: c for i, c in enumerate(VOC_CLASSES) if i > 0}
        self._xml: Dict[int, dict] = {}
        self._coco_index = None

    def __len__(self):
        return len(self.ids)

    def _annotation(self, index: int) -> dict:
        """The image's size and objects (name, 0-based xyxy box,
        difficult), parsed once."""
        ann = self._xml.get(index)
        if ann is None:
            tree = ET.parse(os.path.join(self._ann_dir, f"{self.ids[index]}.xml"))
            size = tree.find("size")
            objects = []
            for obj in tree.findall("object"):
                bb = obj.find("bndbox")
                objects.append((
                    obj.findtext("name", "").lower().strip(),
                    [float(bb.findtext(k)) - 1 for k in ("xmin", "ymin", "xmax", "ymax")],
                    int(obj.findtext("difficult", "0")) == 1,
                ))
            ann = {"height": int(size.findtext("height")), "width": int(size.findtext("width")),
                   "objects": objects}
            self._xml[index] = ann
        return ann

    def get_img_info(self, index: int) -> dict:
        ann = self._annotation(index)
        return {"id": index, "height": ann["height"], "width": ann["width"],
                "file_name": f"{self.ids[index]}.jpg"}

    @property
    def coco(self) -> CocoIndex:
        """The COCO-format view the evaluator reads: integer image ids,
        xywh boxes with the +1 width, difficult objects as ``iscrowd``."""
        if self._coco_index is None:
            images, annotations = [], []
            for idx in range(len(self.ids)):
                images.append(self.get_img_info(idx))
                for name, (x1, y1, x2, y2), difficult in self._annotation(idx)["objects"]:
                    annotations.append({
                        "id": len(annotations) + 1,
                        "image_id": idx,
                        "category_id": self.class_to_ind.get(name, 0),
                        "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                        "area": (x2 - x1 + 1) * (y2 - y1 + 1),
                        "iscrowd": int(difficult),
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
            self._coco_index = index
        return self._coco_index

    def raw_sample(self, index: int) -> Dict:
        """The untransformed sample: uint8 image, the kept objects'
        boxes and labels, zero 28 x 28 masks (VOC has none)."""
        from ...utils.native_image import load_image_rgb

        objects = [o for o in self._annotation(index)["objects"] if self.keep_difficult or not o[2]]
        boxes = np.asarray([o[1] for o in objects], np.float32).reshape(-1, 4)
        return {
            "image": load_image_rgb(os.path.join(self._img_dir, f"{self.ids[index]}.jpg")),
            "boxes": boxes,
            "labels": np.asarray([self.class_to_ind.get(o[0], 0) for o in objects], np.int64),
            "gt_masks": np.zeros((len(boxes), 28, 28), np.float32),
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
