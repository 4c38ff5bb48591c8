"""The language backbones: the word-embedding table and the full BERT.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/language/
bert.py``: ``WordEmbeddingBackbone`` (:26), a ``[vocab, hidden]`` lookup
with which the student-teacher model embeds its caption nouns (frozen
unless ``MODEL.LANGUAGE_BACKBONE.FT_EMB``); ``BertSelfAttention`` (:43),
``BertLayer`` (:67), ``BertEncoder`` (:91) and ``BertModel`` (:118), the
MMSS language backbone and the transformer head's encoder; and
``apply_mlm_masking`` (:163).

No dropout: the JAX modules run ``deterministic``.  The attention is
plain matmuls and a softmax, as in JAX, with JAX's dtypes: the logits
come out of the compute dtype, the float32 mask term promotes them, and
the softmax and its product with the values run in float32.  Every
LayerNorm returns float32 (flax's LayerNorm without ``dtype``), GELU is
the exact erf form and the LayerNorm epsilon 1e-12.
"""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import LayerNorm, Linear


class WordEmbeddingBackbone(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768):
        super().__init__()
        self.word_embeddings = nn.Parameter(torch.zeros(vocab_size, hidden_size))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.word_embeddings[input_ids.to(torch.int64)]


# the mask's additive term (JAX: ``jnp.finfo(jnp.float32).min / 2``)
BIG_NEG = torch.finfo(torch.float32).min / 2


class BertSelfAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        width = num_heads * self.head_dim
        for name in ("query", "key", "value"):
            setattr(self, name, Linear(hidden_size, width, dtype=dtype, heads_out=num_heads))
        self.output = Linear(width, hidden_size, dtype=dtype, heads_in=num_heads)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``x`` ``[B, T, hidden]``, ``mask`` ``[B, T]`` (True: attend)."""
        b, t, _ = x.shape

        def heads(proj):
            return proj(x).view(b, t, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        # the logits in the compute dtype, scaled there (JAX divides by
        # a weakly typed sqrt(head_dim))
        attn = torch.matmul(q, k.transpose(-1, -2)) / torch.full(
            (), float(self.head_dim) ** 0.5, dtype=q.dtype, device=q.device
        )
        neg = torch.where(mask[:, None, None, :], torch.zeros((), device=x.device),
                          torch.full((), BIG_NEG, device=x.device))
        attn = torch.softmax(attn.to(torch.float32) + neg, dim=-1)
        out = torch.matmul(attn, v.to(torch.float32))  # [B, H, T, D], float32
        return self.output(out.transpose(1, 2).reshape(b, t, -1))


class BertLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 layer_norm_eps: float = 1e-12, dtype=torch.float32):
        super().__init__()
        self.attention = BertSelfAttention(hidden_size, num_heads, dtype)
        self.attention_ln = LayerNorm(hidden_size, eps=layer_norm_eps)
        self.intermediate = Linear(hidden_size, intermediate_size, dtype=dtype)
        self.output = Linear(intermediate_size, hidden_size, dtype=dtype)
        self.output_ln = LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.attention_ln(x + self.attention(x, mask))
        h = self.output(F.gelu(self.intermediate(x)))
        return self.output_ln(x + h)


class BertEncoder(nn.Sequential):
    """``num_layers`` ``BertLayer`` s (``layer0`` ...) over embedded
    tokens."""

    def __init__(self, num_layers: int, hidden_size: int = 768, num_heads: int = 12,
                 intermediate_size: int = 3072, layer_norm_eps: float = 1e-12, dtype=torch.float32):
        super().__init__()
        for i in range(num_layers):
            self.add_module(
                f"layer{i}",
                BertLayer(hidden_size, num_heads, intermediate_size, layer_norm_eps, dtype),
            )

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = layer(x, mask)
        return x


class BertModel(nn.Module):
    """Word, position and token-type embeddings, a LayerNorm, then the
    encoder.  Returns the encoded tokens and the word table."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, intermediate_size: int = 3072,
                 max_position_embeddings: int = 512, type_vocab_size: int = 2,
                 layer_norm_eps: float = 1e-12, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.word_embeddings = nn.Parameter(torch.zeros(vocab_size, hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(max_position_embeddings, hidden_size))
        self.token_type_embeddings = nn.Parameter(torch.zeros(type_vocab_size, hidden_size))
        self.embeddings_ln = LayerNorm(hidden_size, eps=layer_norm_eps)
        self.encoder = BertEncoder(num_layers, hidden_size, num_heads, intermediate_size,
                                   layer_norm_eps, dtype)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        seq = input_ids.shape[1]
        x = (self.word_embeddings[input_ids.to(torch.int64)] + self.position_embeddings[None, :seq]
             + self.token_type_embeddings[0][None, None])
        x = self.embeddings_ln(x)
        return self.encoder(x.to(self.dtype), attention_mask), self.word_embeddings


def apply_mlm_masking(
    input_ids: torch.Tensor,
    special_tokens_mask: torch.Tensor,
    attention_mask: torch.Tensor,
    select_u: torch.Tensor,
    mask_u: torch.Tensor,
    random_ids: torch.Tensor,
    mask_token_id: int = 103,
    prob: float = 0.15,
    prob_mask: float = 0.9,
    prob_noise: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked-language-modelling corruption: each real, non-special
    token is selected where ``select_u < prob``; a selected token becomes
    ``mask_token_id`` where ``mask_u < prob_mask``, ``random_ids`` where
    ``mask_u`` falls in the next ``prob_noise``, else stays.  The three
    draws are ``input_ids``-shaped: two uniforms in [0, 1) and ids in
    [0, vocab).  Returns (corrupted ids, selected mask)."""
    eligible = (special_tokens_mask == 0) & (attention_mask == 1)
    selected = (select_u < prob) & eligible
    corrupted = torch.where(
        selected & (mask_u < prob_mask),
        torch.full((), mask_token_id, dtype=input_ids.dtype, device=input_ids.device),
        torch.where(
            selected & (mask_u >= prob_mask) & (mask_u < prob_mask + prob_noise),
            random_ids.to(input_ids.dtype),
            input_ids,
        ),
    )
    return corrupted, selected
