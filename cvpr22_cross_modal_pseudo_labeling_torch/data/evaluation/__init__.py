"""Evaluation dispatch (reference data/datasets/evaluation/__init__.py:8-32).

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
evaluation/__init__.py``.  COCO-style datasets (COCODataset,
COCOCapDetDataset, CityScapesDataset) evaluate through the COCO
protocol; a dataset with an ``imagelevel`` table gets the OpenImages
image-level-verified-class prediction filter (openimages_coco_eval.py:
92-163) before the same protocol; a dataset marked ``eval_protocol =
"voc"`` (PascalVOCDataset) gets the VOC metric of ``voc_eval.py``
(:45-58 of the JAX module): ``bbox/mAP`` and ``bbox/AP_class_<id>`` by
the area under the curve, the same with ``_07metric`` by the 11-point
interpolation.
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
    detections. Returns a flat metric dict including per-split AP50, or
    the VOC metrics for a VOC-protocol dataset (box-only, whatever
    ``iou_types`` asks)."""
    coco = dataset.coco
    if getattr(dataset, "eval_protocol", "coco") == "voc":
        from .voc_eval import eval_detection_voc_all_metrics

        results = {}
        cont, points11 = eval_detection_voc_all_metrics(detections, coco)
        for tag, out in (("", cont), ("_07metric", points11)):
            for k, v in out.items():
                results[f"bbox/{k}{tag}"] = v
        failures = check_expected_results(results, expected_results, expected_results_sigma_tol)
        results["expected_results_failures"] = len(failures)
        return results
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
