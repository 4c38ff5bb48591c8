"""Host-side image/target transforms (numpy/PIL).

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
transforms.py``, with PIL imported where it resizes.

Re-design of reference data/transforms/transforms.py: Resize (random
choice of min side, max-side cap), horizontal/vertical flip, color
jitter, Caffe2 normalization (TO_BGR255 + pixel-mean subtraction,
transforms.py:110-120, INPUT.PIXEL_MEAN defaults.py:62).

Samples are plain dicts:
  image: float32 [H, W, 3] (RGB 0..1 until Normalize),
  boxes: [N, 4] xyxy float32,
  labels: [N] int64,
  gt_masks: [N, M, M] float32 box-local instance masks — invariant under
    resize (box-relative coordinates don't change) and mirrored on flip,
    so geometric transforms never touch pixel-level segmentation data,
plus passthrough caption/metadata keys.
"""

import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.boxes import TO_REMOVE


def get_resize_hw(
    orig_hw: Tuple[int, int], min_size: int, max_size: Optional[int]
) -> Tuple[int, int]:
    """Shorter-side resize with longer-side cap (transforms.py Resize
    get_size semantics)."""
    h, w = orig_hw
    size = float(min_size)
    if max_size is not None:
        min_orig, max_orig = float(min(h, w)), float(max(h, w))
        if max_orig / min_orig * size > max_size:
            size = round(max_size * min_orig / max_orig)
    if (h <= w and h == size) or (w <= h and w == size):
        return h, w
    if h < w:
        return int(size), int(size * w / h)
    return int(size * h / w), int(size)


# COCO person keypoints: left/right pair swap under horizontal flip
# (reference structures/keypoint.py:98-130 PersonKeypoints.FLIP_INDS)
PERSON_KP_FLIP_INDS = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


def resize_image(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Bilinear resize preserving the dtype convention (uint8 stays
    uint8, float 0..1 stays float 0..1); native resize with PIL
    fallback.  uint8 is the fast path: images stay uint8 from decode to
    Normalize, avoiding two full-image float round-trips.  Shared by
    Resize and the TTA variant runner (engine/inference.py)."""
    was_u8 = img.dtype == np.uint8
    src_u8 = img if was_u8 else (img * 255).astype(np.uint8)
    from ..utils.native_image import resize_bilinear_native

    resized = resize_bilinear_native(src_u8, (nh, nw))
    if resized is None:  # PIL fallback
        from PIL import Image

        resized = np.asarray(
            Image.fromarray(src_u8).resize((nw, nh), Image.BILINEAR)
        )
    return resized if was_u8 else resized.astype(np.float32) / 255.0


class Resize:
    def __init__(self, min_sizes: Sequence[int], max_size: int):
        self.min_sizes = tuple(min_sizes)
        self.max_size = max_size

    def __call__(self, sample: Dict, rng: random.Random) -> Dict:
        min_size = rng.choice(self.min_sizes)
        img = sample["image"]
        h, w = img.shape[:2]
        nh, nw = get_resize_hw((h, w), min_size, self.max_size)
        if (nh, nw) != (h, w):
            sample["image"] = resize_image(img, nh, nw)
            sx, sy = nw / w, nh / h
            if len(sample.get("boxes", [])):
                sample["boxes"] = sample["boxes"] * np.array(
                    [sx, sy, sx, sy], np.float32
                )
            if sample.get("keypoints") is not None:
                kp = sample["keypoints"].copy()
                kp[..., 0] *= sx
                kp[..., 1] *= sy
                sample["keypoints"] = kp
            # box-local gt_masks are invariant under resize
        return sample


class RandomHorizontalFlip:
    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def __call__(self, sample: Dict, rng: random.Random) -> Dict:
        if rng.random() >= self.prob:
            return sample
        img = sample["image"][:, ::-1].copy()
        h, w = img.shape[:2]
        sample["image"] = img
        if len(sample.get("boxes", [])):
            b = sample["boxes"]
            x1 = w - b[:, 2] - TO_REMOVE
            x2 = w - b[:, 0] - TO_REMOVE
            sample["boxes"] = np.stack(
                [x1, b[:, 1], x2, b[:, 3]], axis=1
            ).astype(np.float32)
        if len(sample.get("gt_masks", [])):
            sample["gt_masks"] = sample["gt_masks"][:, :, ::-1].copy()
        if sample.get("keypoints") is not None:
            kp = sample["keypoints"]
            if kp.shape[1] == len(PERSON_KP_FLIP_INDS):
                kp = kp[:, PERSON_KP_FLIP_INDS]
            kp = kp.copy()
            kp[..., 0] = w - kp[..., 0] - TO_REMOVE
            # COCO convention: invisible keypoints stay at (0, 0)
            kp[kp[..., 2] == 0] = 0
            sample["keypoints"] = kp
        return sample


class RandomVerticalFlip:
    def __init__(self, prob: float = 0.0):
        self.prob = prob

    def __call__(self, sample: Dict, rng: random.Random) -> Dict:
        if self.prob <= 0 or rng.random() >= self.prob:
            return sample
        img = sample["image"][::-1].copy()
        h = img.shape[0]
        sample["image"] = img
        if len(sample.get("boxes", [])):
            b = sample["boxes"]
            y1 = h - b[:, 3] - TO_REMOVE
            y2 = h - b[:, 1] - TO_REMOVE
            sample["boxes"] = np.stack(
                [b[:, 0], y1, b[:, 2], y2], axis=1
            ).astype(np.float32)
        if len(sample.get("gt_masks", [])):
            sample["gt_masks"] = sample["gt_masks"][:, ::-1, :].copy()
        if sample.get("keypoints") is not None:
            # a vertical reflection also flips chirality: left/right
            # keypoint labels must swap exactly as in the horizontal
            # flip, or they become wrong training targets (the
            # reference raises NotImplementedError for keypoints +
            # vertical flip, structures/keypoint.py transpose; ADVICE
            # r2 low)
            kp = sample["keypoints"]
            if kp.shape[1] == len(PERSON_KP_FLIP_INDS):
                kp = kp[:, PERSON_KP_FLIP_INDS]
            kp = kp.copy()
            kp[..., 1] = h - kp[..., 1] - TO_REMOVE
            kp[kp[..., 2] == 0] = 0
            sample["keypoints"] = kp
        return sample


class ColorJitter:
    """Brightness/contrast/saturation jitter (hue omitted: the shipped
    configs set all factors to 0 — defaults.py:69-73)."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    def __call__(self, sample: Dict, rng: random.Random) -> Dict:
        if not (self.brightness > 0 or self.contrast > 0 or self.saturation > 0):
            return sample  # shipped configs: all factors 0 -> no-op
        img = sample["image"]
        was_u8 = img.dtype == np.uint8
        peak = 255.0 if was_u8 else 1.0
        if was_u8:
            img = img.astype(np.float32)
        if self.brightness > 0:
            img = img * rng.uniform(
                1 - self.brightness, 1 + self.brightness
            )
        if self.contrast > 0:
            mean = img.mean()
            img = (img - mean) * rng.uniform(
                1 - self.contrast, 1 + self.contrast
            ) + mean
        if self.saturation > 0:
            gray = img.mean(axis=2, keepdims=True)
            img = gray + (img - gray) * rng.uniform(
                1 - self.saturation, 1 + self.saturation
            )
        img = np.clip(img, 0.0, peak)
        sample["image"] = img.astype(np.uint8) if was_u8 else img
        return sample


class Normalize:
    def __init__(self, mean, std, to_bgr255=True, defer_uint8=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_bgr255 = to_bgr255
        # INPUT.DEVICE_NORMALIZE: keep uint8 images raw; the model
        # normalizes on device (models/backbone.py:device_normalize).
        # Non-uint8 images (TTA rescales etc.) still normalize here.
        self.defer_uint8 = defer_uint8

    def __call__(self, sample: Dict, rng: random.Random) -> Dict:
        img = sample["image"]
        if img.dtype == np.uint8 and self.defer_uint8:
            return sample
        if img.dtype == np.uint8:  # fast path: one float conversion
            img = img.astype(np.float32)
            if self.to_bgr255:
                img = img[:, :, ::-1]
            else:
                img = img / 255.0
        elif self.to_bgr255:
            img = img[:, :, ::-1] * 255.0
        sample["image"] = (img - self.mean) / self.std
        return sample


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample: Dict, rng: random.Random) -> Dict:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


def build_transforms(cfg, is_train: bool) -> Compose:
    """data/transforms/build.py equivalent."""
    if is_train:
        min_sizes = cfg.INPUT.MIN_SIZE_TRAIN
        if isinstance(min_sizes, (int, float)):
            min_sizes = (min_sizes,)
        max_size = cfg.INPUT.MAX_SIZE_TRAIN
        hflip = cfg.INPUT.HORIZONTAL_FLIP_PROB_TRAIN
        vflip = cfg.INPUT.VERTICAL_FLIP_PROB_TRAIN
        jitter = ColorJitter(
            cfg.INPUT.BRIGHTNESS,
            cfg.INPUT.CONTRAST,
            cfg.INPUT.SATURATION,
            cfg.INPUT.HUE,
        )
        ts = [
            jitter,
            Resize(min_sizes, max_size),
            RandomHorizontalFlip(hflip),
            RandomVerticalFlip(vflip),
        ]
    else:
        ts = [Resize((cfg.INPUT.MIN_SIZE_TEST,), cfg.INPUT.MAX_SIZE_TEST)]
    ts.append(
        Normalize(
            cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD, cfg.INPUT.TO_BGR255,
            defer_uint8=cfg.INPUT.DEVICE_NORMALIZE,
        )
    )
    return Compose(ts)
