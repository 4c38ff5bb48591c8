"""Converts model outputs to COCO-format results.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
evaluation/prepare.py``.

Re-design of prepare_for_coco_detection / prepare_for_coco_segmentation
(reference: data/datasets/evaluation/coco/coco_eval.py:77-146): rescale
padded-resolution detections back to original image size, xyxy(+1) ->
xywh, paste 14x14 mask probabilities into the image frame (host-side
Masker numerics, ops/masks.paste_masks_np) and RLE-encode.
"""

from typing import Dict, List, Optional

import numpy as np

from ...core.boxes import TO_REMOVE
from ...utils.rle import encode_mask, encode_pasted_mask


def detections_to_coco_results(
    boxes: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    valid: np.ndarray,
    mask_probs: Optional[np.ndarray],
    image_id: int,
    input_hw,
    original_hw,
    contiguous_to_json: Dict[int, int],
    mask_threshold: float = 0.5,
    keypoints: Optional[np.ndarray] = None,
) -> List[dict]:
    """One image's padded detections -> list of COCO result dicts.

    ``keypoints`` [D, K, 3] (x, y, score) adds flat COCO keypoint
    triplets with visibility 1 (prepare_for_coco_keypoint,
    reference coco_eval.py:165-196)."""
    keep = np.asarray(valid)
    boxes = np.asarray(boxes)[keep]
    scores = np.asarray(scores)[keep]
    labels = np.asarray(labels)[keep]
    if mask_probs is not None:
        mask_probs = np.asarray(mask_probs)[keep]
    if keypoints is not None:
        keypoints = np.asarray(keypoints)[keep]

    ih, iw = float(input_hw[0]), float(input_hw[1])
    oh, ow = float(original_hw[0]), float(original_hw[1])
    sx, sy = ow / iw, oh / ih
    boxes_orig = boxes * np.array([sx, sy, sx, sy], np.float32)

    results = []
    masks = mask_probs is not None and len(boxes_orig) > 0
    for i in range(len(boxes_orig)):
        x1, y1, x2, y2 = boxes_orig[i]
        res = {
            "image_id": int(image_id),
            "category_id": int(
                contiguous_to_json.get(int(labels[i]), int(labels[i]))
            ),
            "bbox": [
                float(x1),
                float(y1),
                float(x2 - x1 + TO_REMOVE),
                float(y2 - y1 + TO_REMOVE),
            ],
            "score": float(scores[i]),
        }
        if masks:
            # fused box-local paste + RLE: O(box area), no H x W canvas
            res["segmentation"] = encode_pasted_mask(
                mask_probs[i],
                boxes_orig[i],
                (int(oh), int(ow)),
                threshold=mask_threshold,
            )
        if keypoints is not None:
            kp = keypoints[i].astype(np.float64).copy()
            kp[:, 0] *= sx
            kp[:, 1] *= sy
            flat = np.ones((kp.shape[0], 3), np.float64)
            flat[:, 0] = kp[:, 0]
            flat[:, 1] = kp[:, 1]
            res["keypoints"] = [float(v) for v in flat.reshape(-1)]
        results.append(res)
    return results


def attach_gt_segmentations(coco_index):
    """Decodes/attaches RLE for GT annotations lacking one (polygon GT)
    so segm evaluation can IoU them."""
    from ...utils.rle import coco_segmentation_to_mask

    for img_id, anns in coco_index.img_to_anns.items():
        info = coco_index.imgs[img_id]
        for a in anns:
            seg = a.get("segmentation")
            if not seg:
                # None or [] (box-only GT in some COCO-style exports):
                # leave it mask-less so the segm protocol drops it
                # instead of minting an unmatchable zero-area RLE
                continue
            if isinstance(seg, dict) and isinstance(
                seg.get("counts"), str
            ):
                continue  # already compressed RLE
            mask = coco_segmentation_to_mask(
                seg, info["height"], info["width"]
            )
            a["segmentation"] = encode_mask(mask)
