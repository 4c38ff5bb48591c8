"""Visualization: detection and mask overlays and uncertainty heatmaps.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/utils/
visualization.py`` (reference engine/inference.py:212-779, the
visualization_uncertainty and visualization_mask helpers).  numpy and
PIL, no matplotlib: boxes, labels and masks drawn onto an image, and
per-box uncertainty maps rendered as a red heat overlay, for looking at
the teacher's pseudo-labels and the student's uncertainty.
"""

import os
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw

_PALETTE = [
    (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (250, 190, 190), (0, 128, 128), (230, 190, 255),
]


def _color(i: int) -> Tuple[int, int, int]:
    return _PALETTE[i % len(_PALETTE)]


def denormalize_image(image: np.ndarray, pixel_mean=(102.9801, 115.9465, 122.7717),
                      to_bgr255: bool = True) -> np.ndarray:
    """Inverts the Caffe2 normalization back to uint8 RGB; a uint8 image
    (an ``INPUT.DEVICE_NORMALIZE`` batch) is raw RGB already."""
    if image.dtype == np.uint8:
        return image
    img = image + np.asarray(pixel_mean, np.float32)
    if to_bgr255:
        img = img[:, :, ::-1]
    else:
        img = img * 255.0
    return np.clip(img, 0, 255).astype(np.uint8)


def overlay_detections(
    image_rgb: np.ndarray,
    boxes: np.ndarray,
    scores: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    masks: Optional[np.ndarray] = None,
    score_thresh: float = 0.5,
    mask_alpha: float = 0.45,
) -> np.ndarray:
    """Draws boxes (with scores and labels) and full-image masks [N, H, W]."""
    img = Image.fromarray(image_rgb.copy())
    if masks is not None:
        base = np.asarray(img, np.float32)
        for i, m in enumerate(masks):
            if scores is not None and scores[i] < score_thresh:
                continue
            color = np.asarray(_color(i), np.float32)
            mm = (np.asarray(m) > 0).astype(np.float32)[..., None]
            base = base * (1 - mask_alpha * mm) + color * mask_alpha * mm
        img = Image.fromarray(base.astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for i, box in enumerate(np.asarray(boxes)):
        if scores is not None and scores[i] < score_thresh:
            continue
        x1, y1, x2, y2 = [float(v) for v in box]
        draw.rectangle([x1, y1, x2, y2], outline=_color(i), width=2)
        tag = []
        if labels is not None:
            li = int(labels[i])
            tag.append(class_names[li] if class_names and li < len(class_names) else str(li))
        if scores is not None:
            tag.append(f"{float(scores[i]):.2f}")
        if tag:
            draw.text((x1 + 2, y1 + 2), " ".join(tag), fill=_color(i))
    return np.asarray(img)


def uncertainty_heatmap(image_rgb: np.ndarray, boxes: np.ndarray, uncertainty_maps: np.ndarray,
                        alpha: float = 0.6) -> np.ndarray:
    """Pastes per-box uncertainty maps [N, M, M] as a red heat overlay
    (visualization_uncertainty, reference inference.py:212-345)."""
    h, w = image_rgb.shape[:2]
    heat = np.zeros((h, w), np.float32)
    for box, umap in zip(np.asarray(boxes), np.asarray(uncertainty_maps)):
        x1, y1, x2, y2 = [int(round(float(v))) for v in box]
        x1, y1 = max(x1, 0), max(y1, 0)
        x2, y2 = min(x2 + 1, w), min(y2 + 1, h)
        if x2 <= x1 or y2 <= y1:
            continue
        patch = np.asarray(Image.fromarray(umap.astype(np.float32)).resize((x2 - x1, y2 - y1), Image.BILINEAR))
        heat[y1:y2, x1:x2] = np.maximum(heat[y1:y2, x1:x2], patch)
    if heat.max() > 0:
        heat = heat / heat.max()
    out = image_rgb.astype(np.float32)
    out[..., 0] = out[..., 0] * (1 - alpha * heat) + 255.0 * alpha * heat
    out[..., 1] = out[..., 1] * (1 - alpha * heat)
    out[..., 2] = out[..., 2] * (1 - alpha * heat)
    return np.clip(out, 0, 255).astype(np.uint8)


def save_visualization(path: str, image: np.ndarray):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(image).save(path)
