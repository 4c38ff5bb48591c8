"""Single-level RoI feature pooling.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/
roi_heads/pooler.py::pool_rois`` (:47) on its single-level path
(``roi_align_mxu``, :66-75).  The multi-level FPN pooler comes with a
later slice.
"""

from typing import Sequence, Tuple

import torch

from ...ops.roi_align import roi_align


def pool_rois(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    output_size: Tuple[int, int],
    scales: Sequence[float],
    sampling_ratio: int,
    bin_stride: int = 1,
) -> torch.Tensor:
    """Pools ``[B, S, 4]`` boxes from one ``[B, H, W, C]`` level.
    Returns ``[B*S, P', Q', C]`` with ``P' = ceil(P / bin_stride)``."""
    if len(features) != 1:
        raise NotImplementedError("multi-level (FPN) pooling is not ported yet")
    out = roi_align(
        features[0], boxes, output_size, scales[0], sampling_ratio,
        bin_stride=bin_stride,
    )
    b, s = boxes.shape[:2]
    return out.reshape(b * s, *out.shape[2:])
