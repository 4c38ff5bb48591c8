"""Writes a synthetic Pascal VOC 2007 tree:

    python -m cvpr22_cross_modal_pseudo_labeling_torch.tools.synth_voc \\
        --out DIR [--train 8] [--test 8] [--sizes 500x375,375x500,500x333] [--seed 0]

The layout is the VOC devkit's, under the name ``data/paths_catalog.py``
looks up (``CMPL_TPU_DATA_DIR=DIR``; ``voc_2007_train`` and
``voc_2007_test``):

- ``voc/VOC2007/JPEGImages/<id>.jpg`` at VOC's sizes (``--sizes``,
  cycled);
- ``voc/VOC2007/Annotations/<id>.xml``: the image's size and 1-6
  objects of the 20 VOC classes, 1-based ``bndbox`` corners, about one
  in five marked ``difficult`` (never an image's first object);
- ``voc/VOC2007/ImageSets/Main/{train,test}.txt``: the ids of each
  split.

Everything is drawn from ``--seed``.
"""

import argparse
import json
import os
import xml.etree.ElementTree as ET
from typing import Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw

from .synth_openimages import JPEG_QUALITY, parse_sizes, photo_like

VOC_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat", "chair", "cow",
    "diningtable", "dog", "horse", "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor",
)
SIZES = ((500, 375), (375, 500), (500, 333))


def _annotation(image_id: str, w: int, h: int, objects) -> ET.ElementTree:
    root = ET.Element("annotation")
    ET.SubElement(root, "folder").text = "VOC2007"
    ET.SubElement(root, "filename").text = f"{image_id}.jpg"
    size = ET.SubElement(root, "size")
    for key, v in (("width", w), ("height", h), ("depth", 3)):
        ET.SubElement(size, key).text = str(v)
    for name, box, difficult in objects:
        obj = ET.SubElement(root, "object")
        ET.SubElement(obj, "name").text = name
        ET.SubElement(obj, "pose").text = "Unspecified"
        ET.SubElement(obj, "truncated").text = "0"
        ET.SubElement(obj, "difficult").text = str(int(difficult))
        bb = ET.SubElement(obj, "bndbox")
        for key, v in zip(("xmin", "ymin", "xmax", "ymax"), box):
            ET.SubElement(bb, key).text = str(v)
    return ET.ElementTree(root)


def write_tree(out: str, train: int = 8, test: int = 8, sizes: Sequence[Tuple[int, int]] = SIZES,
               seed: int = 0) -> dict:
    """Writes the tree under ``out``; returns its counts."""
    rng = np.random.RandomState(seed)
    root = os.path.join(out, "voc", "VOC2007")
    for d in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    splits = {"train": [], "test": []}
    objects_n = difficult_n = 0
    for i in range(train + test):
        image_id = f"{i + 1:06d}"
        w, h = sizes[i % len(sizes)]
        img = Image.fromarray(photo_like(rng, w, h))
        draw = ImageDraw.Draw(img)
        objects = []
        for k in range(rng.randint(1, 7)):
            bw, bh = rng.randint(w // 8, w // 2), rng.randint(h // 8, h // 2)
            x1, y1 = rng.randint(1, w - bw), rng.randint(1, h - bh)
            box = (x1, y1, x1 + bw, y1 + bh)  # 1-based, inclusive
            name = VOC_NAMES[rng.randint(len(VOC_NAMES))]
            difficult = k > 0 and rng.rand() < 0.2
            objects.append((name, box, difficult))
            draw.rectangle([box[0] - 1, box[1] - 1, box[2] - 1, box[3] - 1],
                           fill=tuple(int(v) for v in rng.randint(0, 256, 3)))
        img.save(os.path.join(root, "JPEGImages", f"{image_id}.jpg"), quality=JPEG_QUALITY)
        _annotation(image_id, w, h, objects).write(os.path.join(root, "Annotations", f"{image_id}.xml"))
        splits["train" if i < train else "test"].append(image_id)
        objects_n += len(objects)
        difficult_n += sum(o[2] for o in objects)
    for split, ids in splits.items():
        with open(os.path.join(root, "ImageSets", "Main", f"{split}.txt"), "w") as f:
            f.write("".join(f"{x}\n" for x in ids))
    return {"train": train, "test": test, "objects": objects_n, "difficult": difficult_n}


def main(argv=None):
    p = argparse.ArgumentParser(description="synthetic Pascal VOC 2007 tree")
    p.add_argument("--out", required=True)
    p.add_argument("--train", type=int, default=8)
    p.add_argument("--test", type=int, default=8)
    p.add_argument("--sizes", default="500x375,375x500,500x333", help="JPEG sizes, WxH, cycled")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    wrote = write_tree(args.out, args.train, args.test, parse_sizes(args.sizes), args.seed)
    print(f"wrote {args.out}: {json.dumps(wrote)}")
    return wrote


if __name__ == "__main__":
    main()
