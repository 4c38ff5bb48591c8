"""Evaluation dispatch (reference data/datasets/evaluation/__init__.py:8-32).

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
evaluation/__init__.py``.  COCO-style datasets (COCODataset,
COCOCapDetDataset) evaluate through the COCO protocol; a dataset with an
``imagelevel`` table gets the OpenImages image-level-verified-class
prediction filter (openimages_coco_eval.py:92-163) before the same
protocol.  The VOC protocol waits with its dataset (ROADMAP.md queue A
item 7).
"""

from typing import Dict, List, Optional

import numpy as np

from .coco_eval import CocoStyleEvaluator, check_expected_results
from .prepare import attach_gt_segmentations, detections_to_coco_results


def filter_predictions_imagelevel(
    detections: List[dict], imagelevel: Dict[int, List[int]]
) -> List[dict]:
    """OpenImages protocol: keep predictions only for classes verified
    at image level (openimages_coco_eval.py:92-100,156-163)."""
    out = []
    for d in detections:
        allowed = imagelevel.get(d["image_id"])
        if allowed is None or d["category_id"] in allowed:
            out.append(d)
    return out


def evaluate(
    dataset,
    detections: List[dict],
    iou_types=("bbox",),
    expected_results=(),
    expected_results_sigma_tol: float = 4.0,
) -> Dict[str, float]:
    """Runs the COCO-style evaluation for the given dataset + COCO-format
    detections. Returns a flat metric dict including per-split AP50."""
    coco = dataset.coco
    imagelevel = getattr(dataset, "imagelevel", None)
    if imagelevel:
        detections = filter_predictions_imagelevel(detections, imagelevel)

    results: Dict[str, float] = {}
    for iou_type in iou_types:
        if iou_type == "segm":
            attach_gt_segmentations(coco)
            dets = [d for d in detections if "segmentation" in d]
        elif iou_type == "keypoints":
            dets = [d for d in detections if "keypoints" in d]
        else:
            dets = detections
        ev = CocoStyleEvaluator(coco, iou_type)
        ev.update(dets)
        ev.accumulate()
        summary = ev.summarize()
        for k, v in summary.items():
            results[f"{iou_type}/{k}"] = v
        for cat, ap in ev.per_class_ap50().items():
            name = dataset.categories.get(cat, str(cat))
            results[f"{iou_type}/AP50_class_{name}"] = ap
        splits = getattr(dataset, "class_splits", None)
        if splits:
            for k, v in ev.per_split_ap50(splits).items():
                results[f"{iou_type}/{k}"] = v
    failures = check_expected_results(
        results, expected_results, expected_results_sigma_tol
    )
    results["expected_results_failures"] = len(failures)
    for msg in failures:
        print("FAIL:", msg)
    return results
