"""Box-proposal average recall (AR) evaluation.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
evaluation/box_proposals.py``.

Re-implementation of the COCO-style proposal AR the reference computes
for RPN_ONLY models (reference:
data/datasets/evaluation/coco/coco_eval.py evaluate_box_proposals):
recall of GT boxes by the top-k proposals, averaged over IoU thresholds
0.5:0.05:0.95, per area range.
"""

from typing import Dict, List, Sequence

import numpy as np

from .coco_eval import AREA_RANGES, bbox_iou_xywh

THRESHOLDS = np.arange(0.5, 0.95 + 1e-5, 0.05)


def evaluate_box_proposals(
    proposals_by_image: Dict[int, np.ndarray],
    coco_index,
    area: str = "all",
    limit: int = 1000,
) -> Dict[str, float]:
    """proposals_by_image: image_id -> [N, 5] (x1, y1, x2, y2, score)
    in original-image coordinates."""
    a0, a1 = AREA_RANGES[area]
    gt_overlaps: List[np.ndarray] = []
    num_pos = 0
    for img_id, props in proposals_by_image.items():
        gts = [
            g
            for g in coco_index.load_anns_for_image(img_id)
            if not g.get("iscrowd", 0) and a0 <= g.get("area", 0) <= a1
        ]
        if not gts:
            continue
        gt_xywh = np.asarray([g["bbox"] for g in gts], np.float64)
        num_pos += len(gts)
        if props.shape[0] == 0:
            gt_overlaps.append(np.zeros(len(gts)))
            continue
        order = np.argsort(-props[:, 4], kind="stable")[:limit]
        boxes = props[order, :4]
        xywh = np.concatenate(
            [boxes[:, :2], boxes[:, 2:] - boxes[:, :2] + 1.0], axis=1
        )
        ious = bbox_iou_xywh(xywh, gt_xywh, [False] * len(gts))
        overlaps = np.zeros(len(gts))
        # greedy: repeatedly take the best (proposal, gt) pair
        for _ in range(min(len(gts), len(boxes))):
            argmax = np.unravel_index(np.argmax(ious), ious.shape)
            if ious[argmax] <= 0:
                break
            overlaps[argmax[1]] = ious[argmax]
            ious[argmax[0], :] = -1
            ious[:, argmax[1]] = -1
        gt_overlaps.append(overlaps)
    if num_pos == 0:
        return {"ar": 0.0, "num_pos": 0}
    overlaps = np.concatenate(gt_overlaps)
    recalls = np.array(
        [(overlaps >= t).sum() / num_pos for t in THRESHOLDS]
    )
    return {
        "ar": float(recalls.mean()),
        "recall@0.5": float(recalls[0]),
        "num_pos": num_pos,
    }
