"""COCO-style detection/segmentation evaluation (pycocotools-free).

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
evaluation/coco_eval.py``: every ordering is the same numpy sort.

Re-implementation of the COCOeval protocol consumed by the reference
evaluator (reference: data/datasets/evaluation/coco/coco_eval.py):
greedy score-ordered matching per (image, category) with crowd/area
ignore semantics, 101-point interpolated precision, AP averaged over IoU
0.50:0.95, plus the reference's additions — per-class AP50 and
per-split (seen/unseen) AP50 (coco_eval.py:378-404) and the
expected-results regression check (coco_eval.py:417-436).

Box IoU here follows the COCO protocol (no +1 — areas are w*h of xywh
boxes), distinct from the model-internal legacy +1 convention.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...utils.rle import rle_area, rle_iou_matrix

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)
# keypoint (OKS) protocol: no "small" range, maxDets [20] (COCOeval
# setKpParams)
KP_AREA_RANGES = {
    "all": (0.0, 1e10),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
KP_MAX_DETS = (20,)
# per-keypoint falloff constants (COCO person skeleton)
KP_SIGMAS = np.array(
    [
        0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
        0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
    ]
)


def bbox_iou_xywh(dts: np.ndarray, gts: np.ndarray, iscrowd) -> np.ndarray:
    """COCO protocol bbox IoU (no +1), dts [D,4] xywh, gts [G,4] xywh."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    dx1, dy1 = dts[:, 0], dts[:, 1]
    dx2, dy2 = dts[:, 0] + dts[:, 2], dts[:, 1] + dts[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    da = dts[:, 2] * dts[:, 3]
    ga = gts[:, 2] * gts[:, 3]
    iw = np.clip(
        np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]),
        0,
        None,
    )
    ih = np.clip(
        np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]),
        0,
        None,
    )
    inter = iw * ih
    union = np.where(
        np.asarray(iscrowd)[None, :],
        da[:, None],
        da[:, None] + ga[None, :] - inter,
    )
    return inter / np.maximum(union, 1e-10)


def oks_matrix(dts, gts, iscrowd, sigmas=None) -> np.ndarray:
    """Object-keypoint-similarity matrix (pycocotools computeOks
    semantics, re-implemented from the OKS definition): per visible gt
    keypoint, exp(-d^2 / (2 s^2 k^2)) with s^2 = gt area and k = 2*sigma,
    averaged over visible keypoints; gts with no labeled keypoint fall
    back to distances clamped against the padded gt box."""
    if sigmas is None:
        sigmas = KP_SIGMAS
    D, G = len(dts), len(gts)
    out = np.zeros((D, G), np.float64)
    if D == 0 or G == 0:
        return out
    vars_ = (sigmas * 2.0) ** 2
    d_kp = [np.asarray(d["keypoints"], np.float64).reshape(-1, 3) for d in dts]
    nk = d_kp[0].shape[0] if d_kp else len(sigmas)
    for j, g in enumerate(gts):
        gkp = np.asarray(
            g.get("keypoints", [0.0] * (3 * nk)), np.float64
        ).reshape(-1, 3)
        if gkp.shape[0] < nk:  # instances-style or short annotation
            gkp = np.concatenate(
                [gkp, np.zeros((nk - gkp.shape[0], 3))], axis=0
            )
        xg, yg, vg = gkp[:, 0], gkp[:, 1], gkp[:, 2]
        k1 = int((vg > 0).sum())
        bb = g.get("bbox", [0.0, 0.0, 0.0, 0.0])
        x0, x1 = bb[0] - bb[2], bb[0] + 2 * bb[2]
        y0, y1 = bb[1] - bb[3], bb[1] + 2 * bb[3]
        area = max(float(g.get("area", 0.0)), 1e-10)
        for i in range(D):
            xd, yd = d_kp[i][:, 0], d_kp[i][:, 1]
            if k1 > 0:
                dx = xd - xg
                dy = yd - yg
            else:
                dx = np.maximum(0.0, np.maximum(x0 - xd, xd - x1))
                dy = np.maximum(0.0, np.maximum(y0 - yd, yd - y1))
            e = (dx**2 + dy**2) / vars_[: len(xd)] / (area + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            out[i, j] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] else 0.0
    return out


class CocoStyleEvaluator:
    """Accumulates per-image detections and computes COCO metrics.

    Ground truth comes from a CocoIndex; detections are dicts:
      {image_id, category_id, bbox (xywh), score, segmentation (RLE,
       optional)}.
    """

    def __init__(self, coco_index, iou_type: str = "bbox"):
        self.coco = coco_index
        self.iou_type = iou_type
        if iou_type == "keypoints":
            self.area_ranges = KP_AREA_RANGES
            self.max_dets = KP_MAX_DETS
        else:
            self.area_ranges = AREA_RANGES
            self.max_dets = MAX_DETS
        self.detections: List[dict] = []

    def update(self, detections: Sequence[dict]):
        self.detections.extend(detections)

    # -- core matching ---------------------------------------------------

    def _evaluate_img(self, dts, gts, area_rng, max_det):
        """Single (image, category, area, maxDet) evaluation — kept as
        the reference semantics (and the differential-test surface);
        `accumulate` uses `_evaluate_img_areas`, which computes the IoU
        matrix once and matches once per area at the maxDet cap, then
        column-slices per maxDet (greedy matching is prefix-stable in
        detection score order, so slicing is exact — pycocotools does
        the same, cocoeval.py evaluate/accumulate split)."""
        ai = list(self.area_ranges.values()).index(tuple(area_rng))
        return self._evaluate_img_areas(dts, gts, max_det)[ai]

    def _match_one(self, ious, gt_ignore, iscrowd):
        """Greedy score-ordered matching for one IoU-ordered gt set."""
        T, D, G = len(IOU_THRS), ious.shape[0], ious.shape[1]
        dt_match = np.zeros((T, D), bool)
        gt_match = np.zeros((T, G), bool)
        dt_ignore = np.zeros((T, D), bool)
        for ti, t in enumerate(IOU_THRS):
            for di in range(D):
                best_iou = min(t, 1 - 1e-10)
                m = -1
                for gi in range(G):
                    if gt_match[ti, gi] and not iscrowd[gi]:
                        continue
                    if m > -1 and not gt_ignore[m] and gt_ignore[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_match[ti, di] = True
                gt_match[ti, m] = True
                dt_ignore[ti, di] = gt_ignore[m]
        return dt_match, dt_ignore

    def _evaluate_img_areas(self, dts, gts, max_det):
        """Evaluates one (image, category) for EVERY area range with a
        single IoU computation.  Returns a list aligned with
        AREA_RANGES of (scores, dt_match [T,D], dt_ignore [T,D], n_gt)."""
        dts = sorted(dts, key=lambda d: -d["score"])[:max_det]
        if self.iou_type == "segm":
            # box-only GT annotations (segmentation absent or an empty
            # polygon list, even after attach_gt_segmentations) cannot
            # be mask-matched; drop them from the segm protocol instead
            # of crashing or counting an unmatchable zero-area mask
            # into the recall denominator.  (pycocotools' annToRLE
            # raises here — robustness divergence, documented.)
            gts = [g for g in gts if g.get("segmentation")]
        iscrowd_raw = [bool(g.get("iscrowd", 0)) for g in gts]
        if self.iou_type == "keypoints":
            ious_raw = oks_matrix(dts, gts, iscrowd_raw)
            # pycocotools loadRes derives dt area from the keypoint
            # extent for the OKS protocol
            dt_areas = np.array(
                [
                    (lambda k: (k[:, 0].max() - k[:, 0].min())
                     * (k[:, 1].max() - k[:, 1].min()))(
                        np.asarray(d["keypoints"], np.float64).reshape(-1, 3)
                    )
                    for d in dts
                ]
            )
        elif self.iou_type == "segm":
            ious_raw = rle_iou_matrix(
                [d["segmentation"] for d in dts],
                [g["segmentation"] for g in gts],
                iscrowd_raw,
            )
            dt_areas = np.array(
                [float(rle_area(d["segmentation"])) for d in dts]
            )
        else:
            ious_raw = bbox_iou_xywh(
                np.asarray([d["bbox"] for d in dts], np.float64).reshape(
                    -1, 4
                ),
                np.asarray([g["bbox"] for g in gts], np.float64).reshape(
                    -1, 4
                ),
                iscrowd_raw,
            )
            # unmatched dts outside the area range are ignored; the
            # detection's area is the MASK area for segm eval
            # (pycocotools loadRes computes dt area from the RLE),
            # bbox w*h for bbox eval
            dt_areas = np.array(
                [d["bbox"][2] * d["bbox"][3] for d in dts]
            )
        scores = np.array([d["score"] for d in dts])
        g_areas = np.array([g.get("area", 0) for g in gts])
        g_crowd = np.array(iscrowd_raw, bool)
        T, D = len(IOU_THRS), len(dts)

        if self.iou_type == "keypoints" and gts:
            # pycocotools _prepare: gts with no labeled keypoint are
            # ignored for the OKS protocol.  This must merge BEFORE the
            # no-detections early return below — a keypoint-less GT in a
            # cell with no dts would otherwise count into the recall
            # denominator (npig), deflating AP/AR (ADVICE r2, medium).
            g_crowd = g_crowd | np.array(
                [
                    int(
                        g.get(
                            "num_keypoints",
                            sum(
                                1
                                for v in (g.get("keypoints") or [])[2::3]
                                if v > 0
                            ),
                        )
                    )
                    == 0
                    for g in gts
                ],
                bool,
            )

        if not gts:
            # the common sparse case (detections for a class with no GT
            # in this image): no matching, ignores purely by area
            zero = np.zeros((T, D), bool)
            return [
                (
                    scores,
                    zero,
                    np.broadcast_to(
                        (dt_areas < at0) | (dt_areas > at1), (T, D)
                    ),
                    0,
                )
                for at0, at1 in self.area_ranges.values()
            ]
        if not dts:
            empty = np.zeros((T, 0), bool)
            return [
                (
                    scores,
                    empty,
                    empty,
                    int(
                        (
                            ~(
                                g_crowd
                                | ~((g_areas >= a0) & (g_areas <= a1))
                            )
                        ).sum()
                    ),
                )
                for a0, a1 in self.area_ranges.values()
            ]

        out = []
        for at0, at1 in self.area_ranges.values():
            gt_ignore = g_crowd | ~((g_areas >= at0) & (g_areas <= at1))
            order_g = np.argsort(gt_ignore, kind="stable")
            gi_sorted = gt_ignore[order_g]
            crowd_sorted = [iscrowd_raw[i] for i in order_g]
            dt_match, dt_ignore = self._match_one(
                ious_raw[:, order_g] if len(gts) else ious_raw,
                gi_sorted,
                crowd_sorted,
            )
            oor = (dt_areas < at0) | (dt_areas > at1)
            dt_ignore = dt_ignore | (~dt_match & oor[None, :])
            out.append((scores, dt_match, dt_ignore, int((~gt_ignore).sum())))
        return out

    def accumulate(self) -> Dict:
        """COCOeval accumulate: one IoU computation and A matchings per
        (image, category), maxDet handled by per-image column slicing
        (exact — greedy matching is prefix-stable in score order).  The
        reference's per-(K,A,M) re-evaluation was O(K·A·M·images) with
        K·I annotation scans; this is O(K_active·A·images_active)."""
        cat_ids = self.coco.get_cat_ids()
        img_ids = set(self.coco.get_img_ids())
        dts_by_img_cat: Dict[Tuple, List[dict]] = {}
        for d in self.detections:
            key = (d["image_id"], d["category_id"])
            if d["image_id"] in img_ids:
                dts_by_img_cat.setdefault(key, []).append(d)
        gts_by_img_cat: Dict[Tuple, List[dict]] = {}
        imgs_by_cat: Dict[int, set] = {}
        for img in img_ids:
            for g in self.coco.load_anns_for_image(img):
                key = (img, g["category_id"])
                gts_by_img_cat.setdefault(key, []).append(g)
                imgs_by_cat.setdefault(g["category_id"], set()).add(img)
        for img, cat in dts_by_img_cat:
            imgs_by_cat.setdefault(cat, set()).add(img)

        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(cat_ids), len(self.area_ranges), len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        max_det_cap = max(self.max_dets)

        for ki, cat in enumerate(cat_ids):
            # per area: lists of per-image (scores, match, ignore), npig
            per_area = [
                {"scores": [], "tp": [], "ig": [], "npig": 0}
                for _ in range(A)
            ]
            for img in sorted(imgs_by_cat.get(cat, ())):
                dts = dts_by_img_cat.get((img, cat), [])
                gts = gts_by_img_cat.get((img, cat), [])
                results = self._evaluate_img_areas(dts, gts, max_det_cap)
                for ai, (scores, match, ignore, n_gt) in enumerate(results):
                    acc = per_area[ai]
                    acc["scores"].append(scores)
                    acc["tp"].append(match)
                    acc["ig"].append(ignore)
                    acc["npig"] += n_gt
            for ai in range(A):
                acc = per_area[ai]
                npig = acc["npig"]
                if npig == 0:
                    continue
                for mi, max_det in enumerate(self.max_dets):
                    if acc["scores"]:
                        scores = np.concatenate(
                            [s[:max_det] for s in acc["scores"]]
                        )
                        order = np.argsort(-scores, kind="mergesort")
                        tp = np.concatenate(
                            [m[:, :max_det] for m in acc["tp"]], axis=1
                        )[:, order]
                        ig = np.concatenate(
                            [g[:, :max_det] for g in acc["ig"]], axis=1
                        )[:, order]
                    else:
                        tp = np.zeros((T, 0), bool)
                        ig = np.zeros((T, 0), bool)
                    tps = np.cumsum(tp & ~ig, axis=1).astype(np.float64)
                    fps = np.cumsum(~tp & ~ig, axis=1).astype(np.float64)
                    n = tps.shape[1]
                    if n:
                        recall[:, ki, ai, mi] = tps[:, -1] / npig
                    else:
                        recall[:, ki, ai, mi] = 0.0
                    rc = tps / npig
                    pr = tps / np.maximum(tps + fps, 1e-10)
                    # monotone interpolation from the right
                    pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                    for ti in range(T):
                        inds = np.searchsorted(
                            rc[ti], REC_THRS, side="left"
                        )
                        q = np.zeros(R)
                        ok = inds < n
                        q[ok] = pr[ti][inds[ok]]
                        precision[ti, :, ki, ai, mi] = q
        self._precision = precision
        self._recall = recall
        self._cat_ids = cat_ids
        return {"precision": precision, "recall": recall}

    # -- summaries -------------------------------------------------------

    def _ap(self, iou_thr=None, area="all", max_det=100) -> float:
        ai = list(self.area_ranges).index(area)
        mi = self.max_dets.index(max_det)
        p = self._precision[:, :, :, ai, mi]
        if iou_thr is not None:
            ti = int(np.where(np.isclose(IOU_THRS, iou_thr))[0][0])
            p = p[ti : ti + 1]
        valid = p[p > -1]
        return float(valid.mean()) if valid.size else -1.0

    def _ar(self, area="all", max_det=100) -> float:
        ai = list(self.area_ranges).index(area)
        mi = self.max_dets.index(max_det)
        r = self._recall[:, :, ai, mi]
        valid = r[r > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self) -> Dict[str, float]:
        if self.iou_type == "keypoints":
            md = self.max_dets[0]
            return {
                "AP": self._ap(max_det=md),
                "AP50": self._ap(iou_thr=0.5, max_det=md),
                "AP75": self._ap(iou_thr=0.75, max_det=md),
                "APm": self._ap(area="medium", max_det=md),
                "APl": self._ap(area="large", max_det=md),
                "AR@20": self._ar(max_det=md),
                "ARm": self._ar(area="medium", max_det=md),
                "ARl": self._ar(area="large", max_det=md),
            }
        return {
            "AP": self._ap(),
            "AP50": self._ap(iou_thr=0.5),
            "AP75": self._ap(iou_thr=0.75),
            "APs": self._ap(area="small"),
            "APm": self._ap(area="medium"),
            "APl": self._ap(area="large"),
            "AR@1": self._ar(max_det=1),
            "AR@10": self._ar(max_det=10),
            "AR@100": self._ar(max_det=100),
            "ARs": self._ar(area="small"),
            "ARm": self._ar(area="medium"),
            "ARl": self._ar(area="large"),
        }

    def per_class_ap50(self) -> Dict[int, float]:
        """Per-category AP50 (reference coco_eval.py:378-395)."""
        ti = int(np.where(np.isclose(IOU_THRS, 0.5))[0][0])
        ai = list(self.area_ranges).index("all")
        mi = self.max_dets.index(self.max_dets[-1])
        out = {}
        for ki, cat in enumerate(self._cat_ids):
            p = self._precision[ti, :, ki, ai, mi]
            valid = p[p > -1]
            out[cat] = float(valid.mean()) if valid.size else float("nan")
        return out

    def per_split_ap50(
        self, class_splits: Dict[str, List[int]]
    ) -> Dict[str, float]:
        """Seen/unseen split AP50 (coco_eval.py:396-404)."""
        per_class = self.per_class_ap50()
        out = {}
        for split, cat_ids in class_splits.items():
            vals = [
                per_class[c]
                for c in cat_ids
                if c in per_class and not np.isnan(per_class[c])
            ]
            out[f"AP50_split_{split}"] = (
                float(np.mean(vals)) if vals else float("nan")
            )
        return out


def check_expected_results(
    results: Dict[str, float],
    expected: Sequence,
    sigma_tol: float,
) -> List[str]:
    """TEST.EXPECTED_RESULTS regression hook (coco_eval.py:417-436):
    entries (task, metric, mean, std); returns a list of FAIL messages
    (empty = pass)."""
    failures = []
    for entry in expected:
        task, metric, mean, std = entry
        key = f"{task}/{metric}" if f"{task}/{metric}" in results else metric
        actual = results.get(key)
        if actual is None:
            failures.append(f"missing metric {task}/{metric}")
            continue
        lo, hi = mean - sigma_tol * std, mean + sigma_tol * std
        if not (lo <= actual <= hi):
            failures.append(
                f"{task}/{metric} = {actual:.4f} outside "
                f"[{lo:.4f}, {hi:.4f}]"
            )
    return failures
