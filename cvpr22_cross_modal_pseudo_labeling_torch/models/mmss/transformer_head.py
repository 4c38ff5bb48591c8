"""Single-stream transformer head: masked language modelling over
[caption; regions] and image-caption matching.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/mmss/
transformer_head.py`` (``TransformerHeadStatics`` :26, ``VisualEmbedding``
:37, ``TransformerHead`` :59): the region features and locations are
embedded (two dense layers, summed, a LayerNorm) and encoded with the
caption's BERT tokens by a ``BertEncoder``.  The MLM head (a dense
transform, GELU, LayerNorm, then the decoder tied to the frozen BERT
word table plus ``mlm_bias``) runs on the B matched pairs only; its
logits are a float32 product of operands rounded to the compute dtype.
With ``mmm_loss`` ``cross_entropy`` all B^2 pairs are encoded for the
matching loss; otherwise the ``seq_relationship`` layer enters the loss
with weight zero, so that weight decay still reaches it.
"""

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..language.bert import BertEncoder
from ..layers import LayerNorm, Linear


class TransformerHeadStatics(NamedTuple):
    num_layers: int = 6
    num_heads: int = 8
    intermediate_size: int = 768
    hidden_size: int = 768
    vocab_size: int = 30522
    layer_norm_eps: float = 1e-12
    mmm_loss: str = "cross_entropy"  # "" | "cross_entropy"
    mlm: bool = True


class VisualEmbedding(nn.Module):
    def __init__(self, in_dim: int, hidden_size: int = 768, dtype=torch.float32):
        super().__init__()
        self.image_embeddings = Linear(in_dim, hidden_size, dtype=dtype)
        self.image_location_embeddings = Linear(2, hidden_size, dtype=dtype)
        self.ln = LayerNorm(hidden_size, eps=1e-12)

    def forward(self, image_emb: torch.Tensor, region_loc: torch.Tensor) -> torch.Tensor:
        return self.ln(self.image_embeddings(image_emb) + self.image_location_embeddings(region_loc))


def _ce_matching(global_dist: torch.Tensor):
    lc = torch.log_softmax(-global_dist, dim=0)
    li = torch.log_softmax(-global_dist, dim=1)
    return -(torch.mean(torch.diagonal(lc)) + torch.mean(torch.diagonal(li)))


class TransformerHead(nn.Module):
    def __init__(self, statics: TransformerHeadStatics, in_dim: int = 768, dtype=torch.float32):
        super().__init__()
        s = statics
        self.statics = s
        self.dtype = dtype
        self.visual_emb = VisualEmbedding(in_dim, s.hidden_size, dtype)
        self.encoder = BertEncoder(s.num_layers, s.hidden_size, s.num_heads, s.intermediate_size,
                                   s.layer_norm_eps, dtype)
        self.pooler = Linear(s.hidden_size, s.hidden_size, dtype=dtype)
        # flax's Dense without dtype: float32 parameters promote the input
        self.seq_relationship = Linear(s.hidden_size, 2, dtype=torch.float32)
        self.mlm_transform = Linear(s.hidden_size, s.hidden_size, dtype=dtype)
        self.mlm_ln = LayerNorm(s.hidden_size, eps=s.layer_norm_eps)
        self.mlm_bias = nn.Parameter(torch.zeros(s.vocab_size))

    def _run(self, tokens_t, mask_t, tokens_v, mask_v):
        x = torch.cat([tokens_t.to(self.dtype), tokens_v.to(self.dtype)], dim=1)
        m = torch.cat([mask_t.to(torch.float32), mask_v.to(torch.float32)], dim=1) > 0
        seq = self.encoder(x, m)
        return seq, torch.tanh(self.pooler(seq[:, 0]))

    def forward(
        self,
        image_emb: torch.Tensor,  # [B, R, in_dim] (v2l-projected)
        region_loc: torch.Tensor,  # [B, R, 2]
        region_mask: torch.Tensor,  # [B, R]
        encoded_tokens: torch.Tensor,  # [B, W, hidden] the BERT output
        caption_mask: torch.Tensor,  # [B, W] attention mask
        mlm_mask: torch.Tensor,  # [B, W] positions selected for MLM
        target_ids: torch.Tensor,  # [B, W] original ids
        word_table: torch.Tensor,  # [vocab, hidden] the tied decoder
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        s = self.statics
        b = image_emb.shape[0]
        w = encoded_tokens.shape[1]
        dev = image_emb.device
        visual = self.visual_emb(image_emb, region_loc)
        losses: Dict[str, torch.Tensor] = {}
        info: Dict[str, torch.Tensor] = {}

        # the matched (diagonal) pairs: MLM
        seq_diag, pooled_diag = self._run(encoded_tokens, caption_mask, visual, region_mask)
        h = self.mlm_ln(F.gelu(self.mlm_transform(seq_diag[:, :w])))
        mlm_logits = (
            h.to(self.dtype).to(torch.float32) @ word_table.to(self.dtype).to(torch.float32).T
        ) + self.mlm_bias
        tgt = torch.where(mlm_mask > 0, target_ids.to(torch.int64), -1)
        valid = tgt >= 0
        logp = torch.log_softmax(mlm_logits, dim=-1)
        nll = -torch.gather(logp, -1, tgt.clamp(min=0)[..., None])[..., 0]
        count = valid.sum()
        mlm_loss = torch.sum(nll * valid) / count.clamp(min=1)
        zero = torch.zeros((), device=dev)
        losses["Masked Language Modeling Loss"] = mlm_loss if s.mlm else zero
        hits = ((torch.argmax(mlm_logits, dim=-1) == tgt) & valid).sum().to(torch.float32)
        den = count.to(torch.float32)
        info["Masked Language Modeling Accuracy"] = torch.where(
            den > 0, hits / den.clamp(min=1.0), zero)
        losses["Masked Visual Modeling Loss"] = zero

        if s.mmm_loss == "cross_entropy":
            # all B^2 pairs, caption-major: pair (i, j) is row i * B + j
            _, pooled = self._run(
                encoded_tokens.repeat_interleave(b, dim=0),
                caption_mask.repeat_interleave(b, dim=0),
                visual.repeat(b, 1, 1),
                region_mask.repeat(b, 1),
            )
            global_dist = self.seq_relationship(pooled)[:, 0].reshape(b, b)
            losses["Image Caption Matching Loss"] = _ce_matching(global_dist)
            arange = torch.arange(b, device=dev)
            info["Batch Accuracy (Choose Caption)"] = torch.mean(
                (torch.argmin(global_dist, dim=0) == arange).to(torch.float32))
            info["Batch Accuracy (Choose Image)"] = torch.mean(
                (torch.argmin(global_dist, dim=1) == arange).to(torch.float32))
        else:
            losses["Image Caption Matching Loss"] = torch.sum(self.seq_relationship(pooled_diag)) * 0.0
        return info, losses
