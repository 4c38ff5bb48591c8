"""The embedding-table-only language backbone.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/language/
bert.py::WordEmbeddingBackbone`` (:26): the ``[vocab, hidden]`` table.
The student-teacher model holds it so that its checkpoint loads; eval
does not read it, and the lookup comes with the caption branch of the
training slice.  The full BERT encoder belongs to the MMSS slice.
"""

import torch
from torch import nn


class WordEmbeddingBackbone(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768):
        super().__init__()
        self.word_embeddings = nn.Parameter(torch.zeros(vocab_size, hidden_size))
