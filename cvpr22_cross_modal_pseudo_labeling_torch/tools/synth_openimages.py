"""Writes a synthetic OpenImages + Conceptual Captions tree for the
``configs/conceptual_openimages_det/`` pair:

    python -m cvpr22_cross_modal_pseudo_labeling_torch.tools.synth_openimages \\
        --out DIR [--train 16] [--val 16] [--captions 32] [--seen 200] [--unseen 300] [--seed 0]

The layout is the one ``preprocess/openimages/*`` and
``preprocess/conceptual/extract_conceptual_meta.py`` write, under the
names ``data/paths_catalog.py`` looks up (``CMPL_TPU_DATA_DIR=DIR``):

- ``openimages/zero-shot/instances_train_seen.json`` (the seen classes)
  and ``instances_val_all.json`` (seen and unseen), COCO format: images
  with ``height`` and ``width``, categories with a ``freebase_id``, a
  ``split`` tag and a 768-d ``embedding.BertEmb``, 1-6 boxes an image;
  about a third of the instances carry an ``iseg_file_name`` PNG mask
  under ``openimages/masks/`` (the image's size, 255 inside), the others
  an inline polygon;
- JPEGs under ``openimages/{train,val}/`` at OpenImages-like sizes
  (``--det-sizes``, 1024 x 768 and 768 x 1024 by default, alternating);
- ``openimages/annotations/validation-annotations-human-imagelabels-
  boxable.csv``: each val image's verified classes, leaving the rarest
  of its ground-truth classes out when it has two or more, so that the
  image-level filter of the evaluation drops detections and keeps those
  of the frequent classes;
- ``conceptual/index_train.json`` (id, file name, caption, height and
  width; ``--no-cap-sizes`` leaves the sizes out) and its JPEGs under
  ``conceptual/images/`` (``--cap-sizes``, 640 x 480 and 480 x 640 by
  default), captions of LVIS nouns.

The class names are the paper's split: the first ``--seen`` of
``data/resources/openimages_seen_classes_200.json`` and the first
``--unseen`` of ``openimages_unseen_classes_200.json``.  Everything is
drawn from ``--seed``.
"""

import argparse
import csv
import json
import os
from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw

RESOURCES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "resources")
IMAGELEVEL_CSV = "validation-annotations-human-imagelabels-boxable.csv"
JPEG_QUALITY = 85
# LVIS nouns the caption parser finds
NOUNS = ("cat", "dog", "sofa", "car", "horse", "man", "bottle", "chair", "table", "bird", "boat",
         "person", "umbrella")


def class_names(seen: int, unseen: int) -> Tuple[List[str], List[str]]:
    with open(os.path.join(RESOURCES, "openimages_seen_classes_200.json")) as f:
        seen_names = json.load(f)
    with open(os.path.join(RESOURCES, "openimages_unseen_classes_200.json")) as f:
        unseen_names = json.load(f)
    if seen > len(seen_names) or unseen > len(unseen_names):
        raise ValueError(f"at most {len(seen_names)} seen and {len(unseen_names)} unseen classes")
    return seen_names[:seen], unseen_names[:unseen]


def parse_sizes(text: str) -> List[Tuple[int, int]]:
    """``"1024x768,768x1024"`` -> [(1024, 768), (768, 1024)] (w, h)."""
    return [tuple(int(v) for v in s.split("x")) for s in text.split(",")]


def photo_like(rng, w: int, h: int) -> np.ndarray:
    """Smooth low-frequency content and mild noise: a JPEG of realistic
    size and decode cost."""
    small = rng.randint(0, 255, (h // 16 + 1, w // 16 + 1, 3), np.uint8)
    img = np.asarray(Image.fromarray(small).resize((w, h), Image.BILINEAR), np.int16)
    img = img + rng.randint(-12, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_images(rng, folder: str, prefix: str, n: int, sizes: Sequence[Tuple[int, int]]) -> List[dict]:
    os.makedirs(folder, exist_ok=True)
    images = []
    for i in range(n):
        w, h = sizes[i % len(sizes)]
        name = f"{prefix}{i:06d}"
        Image.fromarray(photo_like(rng, w, h)).save(os.path.join(folder, name + ".jpg"), quality=JPEG_QUALITY)
        images.append({"id": i + 1, "file_name": name + ".jpg", "height": h, "width": w})
    return images


def write_annotations(rng, images: List[dict], cat_ids: Sequence[int], mask_dir: str) -> List[dict]:
    """1-6 instances an image, of long-tailed classes; every third a PNG
    mask, the others an inline hexagon."""
    os.makedirs(mask_dir, exist_ok=True)
    tail = 1.0 / np.arange(1, len(cat_ids) + 1)
    tail /= tail.sum()
    anns = []
    for im in images:
        w_img, h_img = im["width"], im["height"]
        for _ in range(rng.randint(1, 7)):
            w = float(rng.randint(max(w_img // 10, 8), max(w_img // 2, 9)))
            h = float(rng.randint(max(h_img // 10, 8), max(h_img // 2, 9)))
            x = float(rng.randint(0, max(int(w_img - w), 1)))
            y = float(rng.randint(0, max(int(h_img - h), 1)))
            ann = {"id": len(anns) + 1, "image_id": im["id"],
                   "category_id": int(cat_ids[rng.choice(len(cat_ids), p=tail)]),
                   "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0}
            if ann["id"] % 3 == 0:
                mask = Image.new("L", (w_img, h_img), 0)
                ImageDraw.Draw(mask).ellipse([x, y, x + w - 1, y + h - 1], fill=255)
                png = f"{os.path.splitext(im['file_name'])[0]}_{ann['id']:06d}.png"
                mask.save(os.path.join(mask_dir, png))
                ann["iseg_file_name"] = png
                ann["area"] = w * h * np.pi / 4
            else:
                px = [x + w * f for f in (0.25, 0.75, 1.0, 0.75, 0.25, 0.0)]
                py = [y + h * f for f in (0.0, 0.0, 0.5, 1.0, 1.0, 0.5)]
                ann["segmentation"] = [[v for pair in zip(px, py) for v in pair]]
                ann["area"] = w * h * 0.75
            anns.append(ann)
    return anns


def write_tree(out: str, train: int = 16, val: int = 16, captions: int = 32, seen: int = 200,
               unseen: int = 300, det_sizes: Sequence[Tuple[int, int]] = ((1024, 768), (768, 1024)),
               cap_sizes: Sequence[Tuple[int, int]] = ((640, 480), (480, 640)), cap_sizes_in_index: bool = True,
               seed: int = 0) -> dict:
    """Writes the tree under ``out``; returns what it wrote (counts)."""
    rng = np.random.RandomState(seed)
    oi = os.path.join(out, "openimages")
    for sub in ("zero-shot", "annotations"):
        os.makedirs(os.path.join(oi, sub), exist_ok=True)
    seen_names, unseen_names = class_names(seen, unseen)
    cats = [{"id": i + 1, "name": name, "freebase_id": f"/m/synth{i + 1:04d}",
             "split": "seen" if i < seen else "unseen",
             "embedding": {"BertEmb": (0.1 * rng.randn(768)).tolist()}}
            for i, name in enumerate(seen_names + unseen_names)]
    seen_ids = [c["id"] for c in cats if c["split"] == "seen"]
    all_ids = [c["id"] for c in cats]

    masks = os.path.join(oi, "masks")
    train_imgs = write_images(rng, os.path.join(oi, "train"), "oi_train_", train, det_sizes)
    val_imgs = write_images(rng, os.path.join(oi, "val"), "oi_val_", val, det_sizes)
    train_anns = write_annotations(rng, train_imgs, seen_ids, masks)
    val_anns = write_annotations(rng, val_imgs, all_ids, masks)
    for name, imgs, anns, cc in (
        ("instances_train_seen.json", train_imgs, train_anns, [c for c in cats if c["split"] == "seen"]),
        ("instances_val_all.json", val_imgs, val_anns, cats),
    ):
        with open(os.path.join(oi, "zero-shot", name), "w") as f:
            json.dump({"images": imgs, "annotations": anns, "categories": cc}, f)

    mid = {c["id"]: c["freebase_id"] for c in cats}
    rows = 0
    with open(os.path.join(oi, "annotations", IMAGELEVEL_CSV), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["ImageID", "Source", "LabelName", "Confidence"])
        for im in val_imgs:
            gt = sorted({a["category_id"] for a in val_anns if a["image_id"] == im["id"]})
            for c in gt[:-1] if len(gt) > 1 else gt:
                w.writerow([os.path.splitext(im["file_name"])[0], "verification", mid[c], "1"])
                rows += 1

    cc = os.path.join(out, "conceptual")
    cap_imgs = write_images(rng, os.path.join(cc, "images"), "cc_", captions, cap_sizes)
    index = []
    for im in cap_imgs:
        a, b, c = (NOUNS[j] for j in rng.randint(0, len(NOUNS), 3))
        item = {"id": im["id"], "file_name": im["file_name"], "caption": f"a {a} and a {b} next to a {c}"}
        if cap_sizes_in_index:
            item.update(height=im["height"], width=im["width"])
        index.append(item)
    with open(os.path.join(cc, "index_train.json"), "w") as f:
        json.dump(index, f)
    return {"train": train, "val": val, "captions": captions, "classes": len(cats),
            "train_annotations": len(train_anns), "val_annotations": len(val_anns),
            "png_masks": sum("iseg_file_name" in a for a in train_anns + val_anns), "imagelevel_rows": rows}


def main(argv=None):
    p = argparse.ArgumentParser(description="synthetic OpenImages + Conceptual Captions tree")
    p.add_argument("--out", required=True)
    p.add_argument("--train", type=int, default=16)
    p.add_argument("--val", type=int, default=16)
    p.add_argument("--captions", type=int, default=32)
    p.add_argument("--seen", type=int, default=200)
    p.add_argument("--unseen", type=int, default=300)
    p.add_argument("--det-sizes", default="1024x768,768x1024", help="OpenImages JPEG sizes, WxH, alternating")
    p.add_argument("--cap-sizes", default="640x480,480x640", help="Conceptual JPEG sizes, WxH, alternating")
    p.add_argument("--no-cap-sizes", action="store_true", help="leave height and width out of the index")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    wrote = write_tree(args.out, args.train, args.val, args.captions, args.seen, args.unseen,
                       parse_sizes(args.det_sizes), parse_sizes(args.cap_sizes), not args.no_cap_sizes,
                       args.seed)
    print(f"wrote {args.out}: {json.dumps(wrote)}")
    return wrote


if __name__ == "__main__":
    main()
