"""Padded image batches.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/core/
image_list.py`` (reference structures/image_list.py:7-72, ImageList):
images are padded on the host to the batch's largest size, rounded up
to ``size_divisible``, or to a fixed bucket (``TPU.IMAGE_BUCKETS``), in
NHWC.
"""

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass
class ImageBatch:
    """tensors: [B, H, W, 3] padded images; image_sizes: [B, 2] int32
    (h, w) of the content."""

    tensors: torch.Tensor
    image_sizes: torch.Tensor

    @property
    def batch(self) -> int:
        return self.tensors.shape[0]

    @property
    def padded_hw(self) -> Tuple[int, int]:
        return self.tensors.shape[1], self.tensors.shape[2]


def to_image_batch(images: Sequence[np.ndarray], size_divisible: int = 0,
                   bucket_hw: Optional[Tuple[int, int]] = None) -> ImageBatch:
    """Stacks HWC numpy images into a float32 ``ImageBatch`` (to_image_list,
    image_list.py:29-72); ``bucket_hw`` forces the padded size and raises
    for an image larger than it."""
    sizes = np.array([im.shape[:2] for im in images], np.int32)
    if bucket_hw is not None:
        max_h, max_w = bucket_hw
        big = sizes.max(axis=0)
        if big[0] > max_h or big[1] > max_w:
            raise ValueError(
                f"image of size {tuple(int(v) for v in big)} exceeds the forced bucket {tuple(bucket_hw)} "
                f"— check TPU.IMAGE_BUCKETS against INPUT.MAX_SIZE_*"
            )
    else:
        max_h, max_w = sizes.max(axis=0)
    if size_divisible > 0:
        max_h = int(np.ceil(max_h / size_divisible) * size_divisible)
        max_w = int(np.ceil(max_w / size_divisible) * size_divisible)
    batch = np.zeros((len(images), max_h, max_w, images[0].shape[-1]), np.float32)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        batch[i, :h, :w] = im
    return ImageBatch(torch.from_numpy(batch), torch.from_numpy(sizes))
