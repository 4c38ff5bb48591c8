"""Writes a synthetic COCO person-keypoint tree:

    python -m cvpr22_cross_modal_pseudo_labeling_torch.tools.synth_coco_keypoints \\
        --out DIR [--train 8] [--val 8] [--sizes 640x480,480x640,640x427] [--seed 0]

The annotations are COCO's ``person_keypoints`` format, written under the
names ``data/paths_catalog.py`` looks up (``CMPL_TPU_DATA_DIR=DIR``):
``coco_zeroshot_train`` reads
``coco/zero-shot/instances_train2017_seen_2.json`` over
``coco/train2017/``, and ``coco_not_zeroshot_val`` and
``coco_generalized_zeroshot_val`` read ``instances_val2017_seen_2.json``
and ``instances_val2017_all_2.json`` (the same file) over
``coco/val2017/``.

- one category, ``person`` (id 1), with COCO's 17 keypoint names and
  skeleton, so a detector has 2 classes (``ROI_BOX_HEAD.NUM_CLASSES 2``)
  and 17 keypoints (``ROI_KEYPOINT_HEAD.NUM_CLASSES``);
- JPEGs at COCO's sizes (``--sizes``, cycled), 1-4 people an image, each
  a filled box with its 17 keypoints drawn inside it as dots: about one
  in eight unlabeled (``0, 0, 0``), one in eight labeled but occluded
  (visibility 1), the rest visible (2); ``num_keypoints`` counts the
  labeled ones, ``segmentation`` is the box's polygon, ``area`` its area.

Everything is drawn from ``--seed``.
"""

import argparse
import json
import os
from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw

from .synth_openimages import JPEG_QUALITY, parse_sizes, photo_like

KEYPOINT_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear", "left_shoulder", "right_shoulder",
    "left_elbow", "right_elbow", "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle",
)
SKELETON = (
    (16, 14), (14, 12), (17, 15), (15, 13), (12, 13), (6, 12), (7, 13), (6, 7), (6, 8), (7, 9),
    (8, 10), (9, 11), (2, 3), (1, 2), (1, 3), (2, 4), (3, 5), (4, 6), (5, 7),
)
SIZES = ((640, 480), (480, 640), (640, 427))
CATEGORY = {"id": 1, "name": "person", "supercategory": "person", "keypoints": list(KEYPOINT_NAMES),
            "skeleton": [list(e) for e in SKELETON]}


def _people(rng, draw: ImageDraw.ImageDraw, w: int, h: int, image_id: int, first_id: int) -> List[dict]:
    anns = []
    for k in range(rng.randint(1, 5)):
        bw, bh = rng.randint(w // 8, w // 2), rng.randint(h // 6, int(h * 0.8))
        x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
        draw.rectangle([x, y, x + bw - 1, y + bh - 1], fill=tuple(int(v) for v in rng.randint(0, 256, 3)))
        kps = np.zeros((len(KEYPOINT_NAMES), 3))
        kps[:, 0] = rng.uniform(x, x + bw, len(KEYPOINT_NAMES))
        kps[:, 1] = rng.uniform(y, y + bh, len(KEYPOINT_NAMES))
        u = rng.uniform(size=len(KEYPOINT_NAMES))
        kps[:, 2] = np.where(u < 0.125, 0, np.where(u < 0.25, 1, 2))
        kps[kps[:, 2] == 0] = 0.0
        kps[:, :2] = np.round(kps[:, :2], 2)
        for px, py, v in kps:
            if v > 0:
                draw.ellipse([px - 2, py - 2, px + 2, py + 2], fill=(255, 255, 255) if v == 2 else (128, 128, 128))
        anns.append({
            "id": first_id + k, "image_id": image_id, "category_id": 1, "iscrowd": 0,
            "bbox": [float(x), float(y), float(bw), float(bh)], "area": float(bw * bh),
            "segmentation": [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]],
            "keypoints": [float(v) for v in kps.reshape(-1)], "num_keypoints": int((kps[:, 2] > 0).sum()),
        })
    return anns


def write_tree(out: str, train: int = 8, val: int = 8, sizes: Sequence[Tuple[int, int]] = SIZES,
               seed: int = 0) -> dict:
    """Writes the tree under ``out``; returns its counts."""
    rng = np.random.RandomState(seed)
    ann_dir = os.path.join(out, "coco", "zero-shot")
    os.makedirs(ann_dir, exist_ok=True)
    counts = {}
    for split, n, names in (("train2017", train, ("instances_train2017_seen_2.json",)),
                            ("val2017", val, ("instances_val2017_seen_2.json", "instances_val2017_all_2.json"))):
        folder = os.path.join(out, "coco", split)
        os.makedirs(folder, exist_ok=True)
        images, anns = [], []
        for i in range(n):
            w, h = sizes[i % len(sizes)]
            img = Image.fromarray(photo_like(rng, w, h))
            file_name = f"{split}_{i:06d}.jpg"
            anns.extend(_people(rng, ImageDraw.Draw(img), w, h, i + 1, len(anns) + 1))
            img.save(os.path.join(folder, file_name), quality=JPEG_QUALITY)
            images.append({"id": i + 1, "file_name": file_name, "width": w, "height": h})
        blob = {"images": images, "annotations": anns, "categories": [CATEGORY]}
        for name in names:
            with open(os.path.join(ann_dir, name), "w") as f:
                json.dump(blob, f)
        counts[split] = {"images": n, "people": len(anns)}
    return counts


def main(argv=None):
    p = argparse.ArgumentParser(description="synthetic COCO person-keypoint tree")
    p.add_argument("--out", required=True)
    p.add_argument("--train", type=int, default=8)
    p.add_argument("--val", type=int, default=8)
    p.add_argument("--sizes", default="640x480,480x640,640x427", help="JPEG sizes, WxH, cycled")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    wrote = write_tree(args.out, args.train, args.val, parse_sizes(args.sizes), args.seed)
    print(f"wrote {args.out}: {json.dumps(wrote)}")
    return wrote


if __name__ == "__main__":
    main()
