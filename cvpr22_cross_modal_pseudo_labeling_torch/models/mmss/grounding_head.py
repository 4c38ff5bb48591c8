"""Image-caption grounding head: word/region alignment and its
contrastive losses.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/mmss/
grounding_head.py`` (``GroundingStatics`` :23, ``GroundingHead`` :41),
with every option: the local metric (dot, cosine, euclidean), the
alignment (softmax, hardmax, random_categorical, random_top3), the
global metric (aligned_local, reconstruction_mse) and the loss
(matching, cross_entropy, triplet with hardest, easiest or random
negatives).  The head has no parameters.

The pairwise similarity ``sim[i, j, w, r]`` (caption i, image j) is one
product of the ``[B * W, d]`` captions and the ``[B * R, d]`` regions.
The operands are rounded to the compute dtype and multiplied in
float32, as JAX's ``preferred_element_type=float32`` contraction does;
every loss-side quantity is float32.

The random alignments and the random triplet negatives take their noise
as :class:`AlignmentDraws`; a None field is drawn from the generator.
``jax.random.categorical`` is an argmax of the logits plus Gumbel noise
of the logits' shape, so a test hands both sides the same noise.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..rpn.rpn import top_k


class GroundingStatics(NamedTuple):
    local_metric: str = "dot"
    global_metric: str = "aligned_local"
    alignment: str = "softmax"
    temperature: float = 1.0
    loss_type: str = "matching"
    negative_mining: str = "random"
    margin: float = 1.0
    align_words: bool = True
    align_regions: bool = True


class AlignmentDraws(NamedTuple):
    """The grounding head's random draws.  ``w2r``: Gumbel noise of the
    word-to-region choice, the similarity's shape (``[..., W, R]``, a
    choice over R); ``r2w``: of the region-to-word choice, with the word
    axis moved last (``[..., R, W]``); ``triplet``: ``[2, 2, B]`` ints in
    ``[0, B - 1)``, the random negatives' draws per direction (align
    words, align regions) and side (choose caption, choose image)."""

    w2r: Optional[torch.Tensor] = None
    r2w: Optional[torch.Tensor] = None
    triplet: Optional[torch.Tensor] = None


def _gumbel(shape, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)).clamp(min=tiny))


def _one_hot(idx: torch.Tensor, num: int, axis: int) -> torch.Tensor:
    return F.one_hot(idx, num).to(torch.float32).movedim(-1, axis)


class GroundingHead(nn.Module):
    def __init__(self, statics: GroundingStatics, l_dim: int = 768, compute_dtype=torch.float32):
        super().__init__()
        self.statics = statics
        self.l_dim = l_dim
        self.compute_dtype = compute_dtype

    def forward(
        self,
        image_emb: torch.Tensor,  # [B, R, d] (v2l-projected)
        region_mask: torch.Tensor,  # [B, R]
        caption_emb: torch.Tensor,  # [B, W, d]
        caption_mask: torch.Tensor,  # [B, W] real, non-special tokens
        draws: AlignmentDraws = AlignmentDraws(),
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        s = self.statics
        b, r, _ = image_emb.shape
        w = caption_emb.shape[1]
        dev = image_emb.device
        cd = self.compute_dtype
        # the operands rounded to the compute dtype, multiplied in float32
        cap_c = caption_emb.to(cd).to(torch.float32)
        img_c = image_emb.to(cd).to(torch.float32)
        caption_emb = caption_emb.to(torch.float32)
        image_emb = image_emb.to(torch.float32)
        cmask = caption_mask.to(torch.float32)
        rmask = region_mask.to(torch.float32)
        num_words = cmask.sum(dim=1)
        num_regions = rmask.sum(dim=1)

        pairwise = s.loss_type in ("cross_entropy", "triplet")
        if pairwise:
            # sim[i, j, w, r]: caption i against image j
            sim = (cap_c.reshape(b * w, -1) @ img_c.reshape(b * r, -1).T).view(b, w, b, r).permute(0, 2, 1, 3)
            pair_cmask = cmask[:, None, :, None]
            pair_rmask = rmask[None, :, None, :]
            nw = num_words[:, None].expand(b, b)
            nr = num_regions[None, :].expand(b, b)
        else:
            sim = torch.bmm(cap_c, img_c.transpose(1, 2))
            pair_cmask = cmask[:, :, None]
            pair_rmask = rmask[:, None, :]
            nw, nr = num_words, num_regions

        if s.local_metric == "dot":
            local_similarity = sim
            local_distance = -sim
        elif s.local_metric == "cosine":
            i_norm = torch.sqrt(torch.sum(image_emb ** 2, dim=-1))
            c_norm = torch.sqrt(torch.sum(caption_emb ** 2, dim=-1))
            if pairwise:
                denom = c_norm[:, None, :, None] * i_norm[None, :, None, :]
            else:
                denom = c_norm[:, :, None] * i_norm[:, None, :]
            local_similarity = torch.nan_to_num(sim / denom)
            local_distance = 1.0 - local_similarity
        elif s.local_metric == "euclidean":
            i_sq = torch.sum(image_emb ** 2, dim=-1)
            c_sq = torch.sum(caption_emb ** 2, dim=-1)
            if pairwise:
                local_distance = i_sq[None, :, None, :] + c_sq[:, None, :, None] - 2 * sim
            else:
                local_distance = i_sq[:, None, :] + c_sq[:, :, None] - 2 * sim
            local_similarity = -local_distance
        else:
            raise NotImplementedError(s.local_metric)

        temperature = torch.full((), float(s.temperature), device=dev)
        local_similarity = local_similarity / temperature
        local_distance = local_distance / temperature

        pair_valid = (pair_cmask * pair_rmask) > 0
        floor = local_similarity.detach().min() - 100.0
        local_similarity = torch.where(pair_valid, local_similarity, floor)

        w_axis, r_axis = -2, -1
        attention_w2r = attention_r2w = None
        if s.alignment == "softmax":
            if s.align_words:
                attention_w2r = torch.softmax(local_similarity, dim=r_axis)
            if s.align_regions:
                attention_r2w = torch.softmax(local_similarity, dim=w_axis)
        elif s.alignment == "hardmax":
            if s.align_words:
                attention_w2r = _one_hot(torch.argmax(local_similarity, dim=r_axis), r, r_axis)
            if s.align_regions:
                attention_r2w = _one_hot(torch.argmax(local_similarity, dim=w_axis), w, w_axis)
        elif s.alignment in ("random_categorical", "random_top3"):
            sim_w2r = local_similarity  # a choice over R, last
            sim_r2w = local_similarity.movedim(w_axis, -1)  # a choice over W, last
            if s.alignment == "random_top3":
                # uniform over the top 3: 0 on them, -inf elsewhere
                def top3_logits(x):
                    _, idx = top_k(x, 3)
                    hit = torch.zeros_like(x).scatter_(-1, idx, 1.0)
                    return torch.where(hit > 0, 0.0, float("-inf"))

                sim_w2r, sim_r2w = top3_logits(sim_w2r), top3_logits(sim_r2w)
            if s.align_words:
                g = draws.w2r if draws.w2r is not None else _gumbel(sim_w2r.shape, generator, dev)
                attention_w2r = _one_hot(torch.argmax(sim_w2r + g, dim=-1), r, -1)
            if s.align_regions:
                g = draws.r2w if draws.r2w is not None else _gumbel(sim_r2w.shape, generator, dev)
                attention_r2w = _one_hot(torch.argmax(sim_r2w + g, dim=-1), w, w_axis)
        else:
            raise NotImplementedError(s.alignment)

        one = torch.ones_like(nw)
        gd_w2r = gd_r2w = None
        if s.global_metric == "aligned_local":
            if s.align_words:
                a = attention_w2r * pair_cmask
                gd_w2r = torch.sum(a * local_distance, dim=(w_axis, r_axis)) / torch.maximum(nw, one)
            if s.align_regions:
                a = attention_r2w * pair_rmask
                gd_r2w = torch.sum(a * local_distance, dim=(w_axis, r_axis)) / torch.maximum(nr, one)
        elif s.global_metric == "reconstruction_mse":
            if s.align_words:
                att = attention_w2r.to(cd).to(torch.float32)
                if pairwise:
                    rec = torch.einsum("ijwr,jrd->ijwd", att, img_c)
                    err = torch.mean((rec - caption_emb[:, None]) ** 2, dim=-1)
                    gd_w2r = torch.sum(err * cmask[:, None, :], dim=-1)
                else:
                    rec = torch.bmm(att, img_c)
                    err = torch.mean((rec - caption_emb) ** 2, dim=-1)
                    gd_w2r = torch.sum(err * cmask, dim=-1)
                gd_w2r = gd_w2r / torch.maximum(nw, one)
            if s.align_regions:
                att = attention_r2w.to(cd).to(torch.float32)
                if pairwise:
                    rec = torch.einsum("ijwr,iwd->ijrd", att, cap_c)
                    err = torch.mean((rec - image_emb[None]) ** 2, dim=-1)
                    gd_r2w = torch.sum(err * rmask[None], dim=-1)
                else:
                    rec = torch.bmm(att.transpose(1, 2), cap_c)
                    err = torch.mean((rec - image_emb) ** 2, dim=-1)
                    gd_r2w = torch.sum(err * rmask, dim=-1)
                gd_r2w = gd_r2w / torch.maximum(nr, one)
        else:
            raise NotImplementedError(s.global_metric)

        # a pair is valid only when both sides are non-empty (the AND
        # guard of the JAX package, which repaired the reference's OR);
        # an invalid pair is pushed to the largest distance + 100
        ok = (nw > 0) & (nr > 0)

        def guard(gd):
            return torch.where(ok, gd, gd.detach().max() + 100.0)

        losses: Dict[str, torch.Tensor] = {}
        info: Dict[str, torch.Tensor] = {}
        arange = torch.arange(b, device=dev)

        def accuracies(pw_cost, tag):
            info[f"Batch Accuracy ({tag}, Choose Caption)"] = torch.mean(
                (torch.argmin(pw_cost, dim=0) == arange).to(torch.float32))
            info[f"Batch Accuracy ({tag}, Choose Image)"] = torch.mean(
                (torch.argmin(pw_cost, dim=1) == arange).to(torch.float32))

        if s.loss_type == "matching":
            if s.local_metric == "dot":
                raise ValueError("Matching loss undefined for unbounded dot metric")
            if s.align_words:
                losses["Image-Caption Matching Loss (Align Words)"] = torch.mean(guard(gd_w2r))
            if s.align_regions:
                losses["Image-Caption Matching Loss (Align Regions)"] = torch.mean(guard(gd_r2w))
        elif s.loss_type == "cross_entropy":
            def ce_losses(pw_cost, tag):
                lc = torch.log_softmax(-pw_cost, dim=0)
                li = torch.log_softmax(-pw_cost, dim=1)
                losses[f"Cross-Entropy Loss ({tag}, Choose Caption)"] = -torch.mean(torch.diagonal(lc))
                losses[f"Cross-Entropy Loss ({tag}, Choose Image)"] = -torch.mean(torch.diagonal(li))
                accuracies(pw_cost, tag)

            if s.align_words:
                ce_losses(guard(gd_w2r), "Align Words")
            if s.align_regions:
                ce_losses(guard(gd_r2w), "Align Regions")
        elif s.loss_type == "triplet":
            eye = torch.eye(b, dtype=torch.bool, device=dev)
            inf = float("inf")
            draws_t = draws.triplet
            if s.negative_mining == "random" and b >= 2 and draws_t is None:
                draws_t = torch.randint(0, b - 1, (2, 2, b), generator=generator, device=dev)

            def triplet_losses(pw_cost, tag, direction):
                pos = torch.diagonal(pw_cost)
                margin = s.margin
                if b < 2:
                    neg_cap = pos + margin
                    neg_img = pos + margin
                elif s.negative_mining == "hardest":
                    off = torch.where(eye, inf, pw_cost)
                    neg_cap = off.min(dim=0).values
                    neg_img = off.min(dim=1).values
                elif s.negative_mining == "easiest":
                    off = torch.where(eye, -inf, pw_cost)
                    neg_cap = off.max(dim=0).values
                    neg_img = off.max(dim=1).values
                else:  # a random off-diagonal entry per column and per row
                    rc, ri = draws_t[direction, 0], draws_t[direction, 1]
                    rc = rc + (rc >= arange).to(rc.dtype)
                    ri = ri + (ri >= arange).to(ri.dtype)
                    neg_cap = pw_cost[rc, arange]
                    neg_img = pw_cost[arange, ri]
                losses[f"Triplet Loss ({tag}, Choose Caption)"] = torch.mean(F.relu(pos - neg_cap + margin))
                losses[f"Triplet Loss ({tag}, Choose Image)"] = torch.mean(F.relu(pos - neg_img + margin))
                accuracies(pw_cost, tag)

            if s.align_words:
                triplet_losses(guard(gd_w2r), "Align Words", 0)
            if s.align_regions:
                triplet_losses(guard(gd_r2w), "Align Regions", 1)
        else:
            raise NotImplementedError(s.loss_type)
        return info, losses
