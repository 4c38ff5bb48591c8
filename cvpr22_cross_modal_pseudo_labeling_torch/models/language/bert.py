"""The embedding-table-only language backbone.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/language/
bert.py::WordEmbeddingBackbone`` (:26): a ``[vocab, hidden]`` lookup.
The student-teacher model embeds its caption nouns with it; the table is
frozen unless ``MODEL.LANGUAGE_BACKBONE.FT_EMB``.  The full BERT encoder
belongs to the MMSS slice.
"""

import torch
from torch import nn


class WordEmbeddingBackbone(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768):
        super().__init__()
        self.word_embeddings = nn.Parameter(torch.zeros(vocab_size, hidden_size))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.word_embeddings[input_ids.to(torch.int64)]
