"""Box geometry on padded ``[..., 4]`` xyxy tensors.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/core/boxes.py``.
The legacy Detectron "+1" pixel convention (box width = x2 - x1 + 1) is
kept exactly, and every expression keeps the JAX operand order so that
float32 results agree bit for bit.
"""

import torch

TO_REMOVE = 1.0


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area under the legacy +1 convention."""
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU ``[..., M, N]`` between ``a [..., M, 4]`` and
    ``b [..., N, 4]`` with the +1 term and a ``1e-10`` union floor."""
    area_a = box_area(a)
    area_b = box_area(b)
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    w = (x2 - x1 + TO_REMOVE).clamp(min=0.0)
    h = (y2 - y1 + TO_REMOVE).clamp(min=0.0)
    inter = w * h
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-10)


def clip_to_image(boxes: torch.Tensor, image_size: torch.Tensor) -> torch.Tensor:
    """Clips xyxy boxes to ``[0, size - 1]``.  ``image_size`` is
    ``[..., 2]`` (h, w) and broadcasts over the box axis."""
    h = image_size[..., 0].to(boxes.dtype)[..., None]
    w = image_size[..., 1].to(boxes.dtype)[..., None]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.clamp(boxes[..., 0], zero, w - TO_REMOVE)
    y1 = torch.clamp(boxes[..., 1], zero, h - TO_REMOVE)
    x2 = torch.clamp(boxes[..., 2], zero, w - TO_REMOVE)
    y2 = torch.clamp(boxes[..., 3], zero, h - TO_REMOVE)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def nonempty_mask(boxes: torch.Tensor, min_size: float = 0.0) -> torch.Tensor:
    """Keeps boxes whose +1 width and height are both >= ``min_size``."""
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return (w >= min_size) & (h >= min_size)
