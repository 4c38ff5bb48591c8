"""IoU matcher over padded, masked inputs.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/core/matcher.py::
match_boxes`` (:14), batched over any leading axes.
"""

import torch

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2


def match_boxes(
    match_quality: torch.Tensor,
    gt_valid: torch.Tensor,
    high_threshold: float,
    low_threshold: float,
    allow_low_quality_matches: bool = False,
) -> torch.Tensor:
    """Assigns each prediction a gt index or a negative code.

    match_quality ``[..., M, N]`` (IoU of M padded gt against N
    predictions); gt_valid ``[..., M]``.  Returns ``[..., N]`` int64: the
    best gt (the lowest index among ties) when its IoU is at least
    ``high_threshold``, ``BELOW_LOW_THRESHOLD`` under ``low_threshold``,
    ``BETWEEN_THRESHOLDS`` in between.  ``allow_low_quality_matches``
    gives back its best gt to every prediction tied for some gt's
    highest IoU, ties included."""
    quality = torch.where(
        gt_valid[..., :, None], match_quality,
        torch.full((), -1.0, dtype=match_quality.dtype, device=match_quality.device),
    )
    # torch.max along a dim returns the first maximal index, as argmax
    matched_vals, all_matches = quality.max(dim=-2)
    matches = torch.where(
        matched_vals < low_threshold,
        BELOW_LOW_THRESHOLD,
        torch.where(matched_vals < high_threshold, BETWEEN_THRESHOLDS, all_matches),
    )
    if allow_low_quality_matches:
        highest_per_gt = quality.max(dim=-1, keepdim=True).values
        is_best = (quality == highest_per_gt) & gt_valid[..., :, None]
        matches = torch.where(is_best.any(dim=-2), all_matches, matches)
    return matches
