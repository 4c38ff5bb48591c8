"""Panels of predictions beside the ground truth (the port's
``tools/visualize.py``; the reference's visualization_uncertainty and
visualization_mask helpers, engine/inference.py:212-443):

    python -m cvpr22_cross_modal_pseudo_labeling_torch.tools.visualize --config-file X.yaml \\
        --predictions OUTPUT_DIR/predictions_<dataset>.json --out viz/ [--limit 20] \\
        [--score-thresh 0.5] [KEY VALUE ...]

It reads the COCO-format predictions that ``tools/test_net.py`` writes
and renders one PNG an image of ``DATASETS.TEST[0]`` (found under
``CMPL_TPU_DATA_DIR``): the ground-truth boxes on the left, the
predictions on the right (palette boxes, RLE masks, class names with
the unseen split's flagged ``*``, as the reference's
overlay_class_names, inference.py:461-508).
"""

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np


def _xyxy(items) -> np.ndarray:
    return np.asarray([[b[0], b[1], b[0] + b[2], b[1] + b[3]] for b in (d["bbox"] for d in items)],
                      np.float32).reshape(-1, 4)


def render_image(dataset, img_id: int, dets: List[Dict], score_thresh: float, unseen_json_ids) -> np.ndarray:
    """One image's panel: [H, 2W, 3] uint8."""
    from PIL import Image

    from ..utils.rle import decode_rle
    from ..utils.visualization import overlay_detections

    info = dataset.coco.imgs[img_id]
    with Image.open(os.path.join(dataset.root, info["file_name"])) as im:
        image = np.asarray(im.convert("RGB"), np.uint8)
    left = overlay_detections(image, _xyxy(dataset.coco.load_anns_for_image(img_id)))

    dets = [d for d in dets if d["score"] >= score_thresh]
    names = []
    for d in dets:
        name = dataset.coco.cats.get(d["category_id"], {}).get("name", str(d["category_id"]))
        names.append("*" + name if d["category_id"] in unseen_json_ids else name)
    masks = None
    if dets and "segmentation" in dets[0]:
        masks = np.stack([decode_rle(d["segmentation"]) for d in dets])
    right = overlay_detections(
        image, _xyxy(dets), scores=np.asarray([d["score"] for d in dets], np.float32),
        labels=np.arange(len(dets)), class_names=names, masks=masks, score_thresh=score_thresh,
    )
    return np.concatenate([left, right], axis=1)


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Writes the panels; returns their paths."""
    ap = argparse.ArgumentParser(description="prediction panels beside the ground truth (PyTorch port)")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--predictions", required=True)
    ap.add_argument("--out", default="viz")
    ap.add_argument("--limit", type=int, default=20)
    ap.add_argument("--score-thresh", type=float, default=0.5)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    from ..config import get_default_cfg
    from ..data.build import build_dataset
    from ..utils.visualization import save_visualization

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(list(args.opts))
    dataset = build_dataset(cfg, cfg.DATASETS.TEST[:1], None, False)[0]

    with open(args.predictions) as f:
        results = json.load(f)
    by_img: Dict[int, List[Dict]] = {}
    for d in results:
        by_img.setdefault(d["image_id"], []).append(d)
    unseen_json_ids = set()
    for split, ids in getattr(dataset, "class_splits", {}).items():
        if "unseen" in split or split == "target":
            unseen_json_ids.update(int(i) for i in ids)

    os.makedirs(args.out, exist_ok=True)
    paths = []
    for img_id in dataset.coco.get_img_ids()[:max(args.limit, 0)]:
        panel = render_image(dataset, img_id, by_img.get(img_id, []), args.score_thresh, unseen_json_ids)
        paths.append(os.path.join(args.out, f"{img_id:012d}.png"))
        save_visualization(paths[-1], panel)
    print(f"wrote {len(paths)} panels to {args.out}")
    return paths


if __name__ == "__main__":
    main(sys.argv[1:])
