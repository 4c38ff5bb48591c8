"""Balanced positive/negative sampling with static shapes.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/core/sampler.py``
(``_select_random_subset`` :23, ``balanced_sample_masks`` :42,
``balanced_sample_indices`` :74), batched over images: every tensor has
a leading image axis and no function reads a value back to the host (no
``nonzero``, no boolean indexing).

A random subset is the top ``count`` of uniform priorities.  The JAX
functions draw them from a key, per image; here they are a ``[B, 2, N]``
tensor of positive and negative priorities that the caller may pass
(to replay another program's draws), else drawn from ``generator`` on the
masks' device.
"""

from typing import Optional, Tuple

import torch


def draw_priorities(
    b: int, n: int, device, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """``[B, 2, N]`` uniform [0, 1) priorities: positives, then negatives."""
    return torch.rand((b, 2, n), generator=generator, device=device)


def _select_random_subset(
    mask: torch.Tensor, rand: torch.Tensor, count: torch.Tensor, k_cap: int
) -> torch.Tensor:
    """Marks ``count[b]`` eligible elements of ``mask [B, N]`` per image:
    those of the highest priority among the top ``k_cap``."""
    n = mask.shape[1]
    k = min(k_cap, n)
    keyed = torch.where(mask, rand, torch.full((), -float("inf"), device=rand.device))
    # jax.lax.top_k: descending, ties broken by the lower index
    idx = torch.sort(keyed, dim=1, descending=True, stable=True).indices[:, :k]
    take = torch.arange(k, device=mask.device)[None, :] < count[:, None]
    out = torch.zeros_like(mask).scatter_(1, idx, take)
    return out & mask


def balanced_sample_masks(
    pos_mask: torch.Tensor,
    neg_mask: torch.Tensor,
    rand: torch.Tensor,
    batch_size: int,
    positive_fraction: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """At most ``batch_size`` elements per image with the reference's
    quotas: ``min(#pos, batch * frac)`` positives, then ``min(#neg,
    batch - num_pos)`` negatives.  ``rand`` is ``[B, 2, N]``.  Returns
    (sampled_pos, sampled_neg), both ``[B, N]`` bool."""
    num_pos_cap = int(batch_size * positive_fraction)
    num_pos = pos_mask.sum(dim=1).clamp(max=num_pos_cap)
    num_neg = torch.minimum(neg_mask.sum(dim=1), batch_size - num_pos)
    sampled_pos = _select_random_subset(pos_mask, rand[:, 0], num_pos, max(num_pos_cap, 1))
    sampled_neg = _select_random_subset(neg_mask, rand[:, 1], num_neg, batch_size)
    return sampled_pos, sampled_neg


def balanced_sample_indices(
    pos_mask: torch.Tensor,
    neg_mask: torch.Tensor,
    rand: torch.Tensor,
    batch_size: int,
    positive_fraction: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`balanced_sample_masks` compacted to ``[B, batch_size]``:
    indices into the N candidates (sampled positives, then sampled
    negatives, then the rest, each in candidate order), the valid mask
    and the positive mask of the slots."""
    n = pos_mask.shape[1]
    if n < batch_size:
        raise ValueError(f"{n} candidates cannot fill {batch_size} slots")
    sampled_pos, sampled_neg = balanced_sample_masks(
        pos_mask, neg_mask, rand, batch_size, positive_fraction
    )
    # the JAX tier + index / 2N priority, as a stable sort of the tier
    tier = torch.where(sampled_pos, 0, torch.where(sampled_neg, 1, 2))
    indices = torch.sort(tier, dim=1, stable=True).indices[:, :batch_size]
    num_pos = sampled_pos.sum(dim=1, keepdim=True)
    slot = torch.arange(batch_size, device=pos_mask.device)[None, :]
    valid = slot < num_pos + sampled_neg.sum(dim=1, keepdim=True)
    is_pos = slot < num_pos
    return indices, valid, is_pos
