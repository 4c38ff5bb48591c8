"""Self-contained WordPiece tokenizer (host-side).

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/
language/tokenizer.py``.

The reference uses HuggingFace's bert-base-uncased tokenizer
(reference: maskrcnn_benchmark/modeling/language_backbone/transformers.py:20-28);
this environment has no downloaded vocab, so we implement BERT's
WordPiece algorithm directly over a ``vocab.txt`` file (same format).
Behavior matches HF BasicTokenizer(do_lower_case=True) +
WordpieceTokenizer for ASCII text: lowercase, strip accents-less basic
clean, punctuation splitting, greedy longest-match-first wordpieces with
"##" continuation, [UNK] fallback, [CLS]/[SEP] specials, pad to
max_length with attention and special-tokens masks.
"""

import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (
        (33 <= cp <= 47)
        or (58 <= cp <= 64)
        or (91 <= cp <= 96)
        or (123 <= cp <= 126)
    ):
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: Optional[Dict[str, int]] = None,
        vocab_file: Optional[str] = None,
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        mask_token: str = "[MASK]",
        max_wordpiece_chars: int = 100,
    ):
        if vocab is None:
            assert vocab_file is not None
            vocab = {}
            with open(vocab_file, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    vocab[line.rstrip("\n")] = i
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.mask_id = vocab.get(mask_token, vocab[unk_token])
        self.unk_id = vocab[unk_token]
        self.max_wordpiece_chars = max_wordpiece_chars

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _basic_tokenize(self, text: str) -> List[str]:
        if self.do_lower_case:
            text = text.lower()
            text = "".join(
                c for c in unicodedata.normalize("NFD", text)
                if unicodedata.category(c) != "Mn"
            )
        out: List[str] = []
        cur = []
        for ch in text:
            if ch.isspace():
                if cur:
                    out.append("".join(cur))
                    cur = []
            elif _is_punctuation(ch):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out

    def _wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_wordpiece_chars:
            return [self.unk_token]
        pieces = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for tok in self._basic_tokenize(text):
            out.extend(self._wordpiece(tok))
        return out

    def encode(self, text: str, max_length: int) -> Dict[str, np.ndarray]:
        toks = self.tokenize(text)[: max_length - 2]
        ids = [self.cls_id] + [
            self.vocab.get(t, self.unk_id) for t in toks
        ] + [self.sep_id]
        n = len(ids)
        input_ids = np.full(max_length, self.pad_id, np.int32)
        input_ids[:n] = ids
        attention = np.zeros(max_length, np.int32)
        attention[:n] = 1
        special = np.ones(max_length, np.int32)
        special[1 : n - 1] = 0
        return {
            "input_ids": input_ids,
            "attention_mask": attention,
            "special_tokens_mask": special,
        }

    def encode_batch(
        self, texts: Sequence[str], max_length: int
    ) -> Dict[str, np.ndarray]:
        encs = [self.encode(t, max_length) for t in texts]
        return {
            k: np.stack([e[k] for e in encs]) for k in encs[0]
        }


def make_test_vocab(words: Sequence[str]) -> Dict[str, int]:
    """Tiny vocab for unit tests: specials + whole words."""
    vocab = {
        "[PAD]": 0,
        "[UNK]": 1,
        "[CLS]": 2,
        "[SEP]": 3,
        "[MASK]": 4,
    }
    for w in words:
        if w not in vocab:
            vocab[w] = len(vocab)
    return vocab
