"""VOC-style AP evaluation.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
evaluation/voc_eval.py`` (reference voc/voc_eval.py and the OpenImages
``eval_detection_voc``): per-class AP at one IoU threshold, by the area
under the precision/recall curve and by the 11-point interpolation
(VOC2007's metric), both from one greedy matching pass per class.

The IoU against a difficult object is the plain IoU (the VOC devkit
computes the overlaps alike for every object and ignores a difficult
match only at assignment): a detection whose best match is a difficult
object counts neither as a true nor as a false positive, and difficult
objects do not count among the positives.  A class without positives
has a NaN AP and stays out of the mean.
"""

from typing import Dict, List, Tuple

import numpy as np

from .coco_eval import bbox_iou_xywh


def _per_class_pr(
    detections: List[dict], coco_index, iou_thresh: float
) -> Dict[int, Tuple[np.ndarray, np.ndarray, int]]:
    """One greedy-matching pass per class over annotations grouped by
    (image, category) -> {cat: (recall, precision, n_pos)}."""
    cat_ids = coco_index.get_cat_ids()
    # group gt by category then image in ONE pass over all annotations
    # (keyed cat-first so each class below only touches its own groups
    # — flat (img, cat) keys would cost O(classes x groups) rescans at
    # LVIS scale)
    gts_by: Dict[int, Dict[int, list]] = {}
    for img in coco_index.get_img_ids():
        for g in coco_index.load_anns_for_image(img):
            gts_by.setdefault(g["category_id"], {}).setdefault(
                img, []
            ).append(g)
    dets_by_cat: Dict[int, List[dict]] = {c: [] for c in cat_ids}
    for d in detections:
        if d["category_id"] in dets_by_cat:
            dets_by_cat[d["category_id"]].append(d)

    out = {}
    for cat in cat_ids:
        entries = {}
        n_pos = 0
        for img, gts in gts_by.get(cat, {}).items():
            flags = [bool(g.get("iscrowd", 0)) for g in gts]
            n_pos += sum(1 for f in flags if not f)
            entries[img] = (
                np.asarray(
                    [g["bbox"] for g in gts], np.float64
                ).reshape(-1, 4),
                np.asarray(flags, bool),
                np.zeros(len(gts), bool),  # matched flags
            )
        dets = sorted(dets_by_cat[cat], key=lambda d: -d["score"])
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for i, d in enumerate(dets):
            entry = entries.get(d["image_id"])
            if entry is None or len(entry[0]) == 0:
                fp[i] = 1
                continue
            gt_boxes, difficult, matched = entry
            # plain IoU for every GT, difficult included (devkit
            # semantics: overlap first, ignore at assignment)
            ious = bbox_iou_xywh(
                np.asarray(d["bbox"], np.float64).reshape(1, 4),
                gt_boxes,
                np.zeros(len(gt_boxes), bool),
            )[0]
            j = int(np.argmax(ious))
            if ious[j] >= iou_thresh:
                if difficult[j]:
                    continue  # ignore
                if not matched[j]:
                    tp[i] = 1
                    matched[j] = True
                else:
                    fp[i] = 1
            else:
                fp[i] = 1
        tp_c = np.cumsum(tp)
        fp_c = np.cumsum(fp)
        rec = tp_c / max(n_pos, 1)
        prec = tp_c / np.maximum(tp_c + fp_c, 1e-10)
        out[cat] = (rec, prec, n_pos)
    return out


def _ap_continuous(rec: np.ndarray, prec: np.ndarray) -> float:
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for k in range(len(mpre) - 1, 0, -1):
        mpre[k - 1] = max(mpre[k - 1], mpre[k])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _ap_11point(rec: np.ndarray, prec: np.ndarray) -> float:
    ap = 0.0
    for t in np.arange(0.0, 1.1, 0.1):
        p = prec[rec >= t].max() if np.any(rec >= t) else 0.0
        ap += p / 11.0
    return float(ap)


def _format(pr, ap_fn) -> Dict[str, float]:
    aps = {
        cat: (ap_fn(rec, prec) if n_pos > 0 else float("nan"))
        for cat, (rec, prec, n_pos) in pr.items()
    }
    valid = [v for v in aps.values() if not np.isnan(v)]
    out = {f"AP_class_{c}": v for c, v in aps.items()}
    out["mAP"] = float(np.mean(valid)) if valid else float("nan")
    return out


def eval_detection_voc(
    detections: List[dict],
    coco_index,
    iou_thresh: float = 0.5,
    use_07_metric: bool = False,
) -> Dict[str, float]:
    """detections: COCO-format dicts (xywh bbox).  Returns per-class AP
    and mAP."""
    pr = _per_class_pr(detections, coco_index, iou_thresh)
    return _format(pr, _ap_11point if use_07_metric else _ap_continuous)


def eval_detection_voc_all_metrics(
    detections: List[dict], coco_index, iou_thresh: float = 0.5
) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(continuous, 11-point) results from ONE matching pass — the
    greedy matching dominates eval time and is identical for both
    interpolations."""
    pr = _per_class_pr(detections, coco_index, iou_thresh)
    return _format(pr, _ap_continuous), _format(pr, _ap_11point)
