"""Test-time bounding-box augmentation.

The port's counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/
engine/bbox_aug.py`` (``flip_boxes_np`` :21, ``merge_and_filter``
:28-63, ``im_detect_bbox_aug`` :90): run detection at several scales
and with a horizontal flip, map every detection back to the original
frame, merge, and filter the union once (score threshold, class-wise
NMS, top-k).

JAX's merge runs a host NMS per class over that class's score-sorted
boxes.  The port runs one label-gated :func:`ops.nms.nms` over the
union instead: the CUDA kernel on a CUDA device, its plain version on
the CPU.  Only boxes of one label suppress each other, and the global
stable score order restricted to a label is JAX's per-class order, so
the kept set is the same; the same +1 IoU and strict ``>`` as JAX's
``native_nms`` and ``_np_nms`` (:65-87).  The kept indices are then put
in JAX's order (by label, score order within one) before its stable
top-k.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.boxes import TO_REMOVE
from ..data.transforms import get_resize_hw
from ..ops.nms import nms


def flip_boxes_np(boxes: np.ndarray, width: float) -> np.ndarray:
    out = boxes.copy()
    out[:, 0] = width - boxes[:, 2] - TO_REMOVE
    out[:, 2] = width - boxes[:, 0] - TO_REMOVE
    return out


def merge_and_filter(
    all_boxes: List[np.ndarray],
    all_scores: List[np.ndarray],
    all_labels: List[np.ndarray],
    nms_thresh: float = 0.5,
    score_thresh: float = 0.05,
    detections_per_img: int = 100,
    device="cpu",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merges per-augmentation detections and applies the final filter
    (bbox_aug.py:95-131 semantics, class-wise NMS), with the NMS on
    ``device``."""
    boxes = np.concatenate(all_boxes, axis=0)
    scores = np.concatenate(all_scores, axis=0)
    labels = np.concatenate(all_labels, axis=0)
    keep = scores > score_thresh
    boxes, scores, labels = boxes[keep], scores[keep], labels[keep]

    idx = np.zeros(0, np.int64)
    n = len(boxes)
    if n:
        device = torch.device(device)
        kept, valid = nms(
            torch.as_tensor(boxes, dtype=torch.float32).to(device),
            torch.as_tensor(scores, dtype=torch.float32).to(device),
            torch.ones((n,), dtype=torch.bool, device=device),
            nms_thresh,
            n,
            labels=torch.as_tensor(labels).to(device),
        )
        kept = kept.cpu().numpy()[valid.cpu().numpy()].astype(np.int64)
        # JAX's order: the labels ascending, each label's boxes in score order
        idx = kept[np.argsort(labels[kept], kind="stable")]
    if len(idx) > detections_per_img:
        idx = idx[np.argsort(-scores[idx], kind="stable")][
            :detections_per_img
        ]
    return boxes[idx], scores[idx], labels[idx]


def im_detect_bbox_aug(
    run_variant,
    image: np.ndarray,
    scales: Sequence[int],
    max_size: int,
    h_flip: bool,
    scale_h_flip: bool,
    base_scale: int,
    nms_thresh: float = 0.5,
    detections_per_img: int = 100,
    device="cpu",
):
    """Drives the augmentation set (bbox_aug.py:11-94).

    ``run_variant(image, hw, flipped) -> (boxes, scores, labels)`` runs
    the model at a given resize target and returns original-frame
    detections (flipped ones still mirrored)."""
    h, w = image.shape[:2]
    variants = [(base_scale, False)]
    if h_flip:
        variants.append((base_scale, True))
    for s in scales:
        variants.append((s, False))
        if scale_h_flip:
            variants.append((s, True))

    all_b, all_s, all_l = [], [], []
    for scale, flip in variants:
        hw = get_resize_hw((h, w), scale, max_size)
        boxes, scores, labels = run_variant(image, hw, flip)
        if flip:
            boxes = flip_boxes_np(boxes, w)
        all_b.append(boxes)
        all_s.append(scores)
        all_l.append(labels)
    return merge_and_filter(
        all_b, all_s, all_l,
        nms_thresh=nms_thresh,
        detections_per_img=detections_per_img,
        device=device,
    )
