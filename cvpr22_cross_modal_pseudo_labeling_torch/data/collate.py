"""Batch collation: samples -> statically-shaped device batch dict.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
collate.py``.  It pads to ``TPU.IMAGE_BUCKETS`` as the JAX package does,
so that the port's batches equal JAX's; on the card the bucket ladder
bounds the set of shapes the kernels see.

Replaces the reference BatchCollator (data/collate_batch.py:5-31) and
the dynamic ImageList padding: images pad to one of a fixed set of
(H, W) buckets (cfg.TPU.IMAGE_BUCKETS) so XLA compiles a bounded number
of programs; GT/caption payloads pad to cfg.TPU caps with validity
masks.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class HashingTokenizer:
    """Fallback tokenizer for environments without a BERT vocab file:
    whole words hash deterministically into the vocab range (specials
    0-4 reserved).  The BERT table is randomly initialized in that case
    anyway, so hashed ids are an equally-valid token space."""

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size
        self.pad_id, self.unk_id, self.cls_id, self.sep_id, self.mask_id = (
            0, 1, 2, 3, 4,
        )

    def _word_id(self, w: str) -> int:
        import hashlib

        h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
        return 5 + h % (self.vocab_size - 5)

    def encode(self, text: str, max_length: int) -> Dict[str, np.ndarray]:
        words = text.lower().split()[: max_length - 2]
        ids = [self.cls_id] + [self._word_id(w) for w in words] + [self.sep_id]
        n = len(ids)
        out = np.full(max_length, self.pad_id, np.int32)
        out[:n] = ids
        att = np.zeros(max_length, np.int32)
        att[:n] = 1
        special = np.ones(max_length, np.int32)
        special[1 : n - 1] = 0
        return {
            "input_ids": out,
            "attention_mask": att,
            "special_tokens_mask": special,
        }

    def encode_batch(self, texts, max_length):
        encs = [self.encode(t, max_length) for t in texts]
        return {k: np.stack([e[k] for e in encs]) for k in encs[0]}


def build_tokenizer(cfg):
    vocab_file = cfg.MODEL.LANGUAGE_BACKBONE.EMBEDDING_PATH
    if vocab_file and vocab_file.endswith(".txt"):
        from ..models.language.tokenizer import WordPieceTokenizer

        return WordPieceTokenizer(vocab_file=vocab_file)
    return HashingTokenizer()


def select_bucket(
    max_h: int, max_w: int, buckets: Sequence[Tuple[int, int]],
    size_divisible: int = 0,
) -> Tuple[int, int]:
    fitting = [
        (h, w) for h, w in buckets if h >= max_h and w >= max_w
    ]
    if fitting:
        return min(fitting, key=lambda hw: hw[0] * hw[1])
    d = max(size_divisible, 1)
    return (
        int(np.ceil(max_h / d) * d),
        int(np.ceil(max_w / d) * d),
    )


class BatchCollator:
    def __init__(
        self,
        buckets: Sequence[Tuple[int, int]] = ((800, 1344), (1344, 800)),
        max_gt: int = 100,
        max_cap_tokens: int = 128,
        max_cap_nouns: int = 32,
        noun_token_len: int = 8,
        size_divisible: int = 64,
        tokenizer=None,
        gt_mask_size: int = 28,
        keypoint_on: bool = False,
        num_keypoints: int = 17,
    ):
        self.buckets = tuple(tuple(b) for b in buckets)
        self.max_gt = max_gt
        self.max_cap_tokens = max_cap_tokens
        self.max_cap_nouns = max_cap_nouns
        self.noun_token_len = noun_token_len
        self.size_divisible = size_divisible
        self.tokenizer = tokenizer or HashingTokenizer()
        self.gt_mask_size = gt_mask_size
        self.keypoint_on = keypoint_on
        self.num_keypoints = num_keypoints

    @classmethod
    def from_cfg(cls, cfg, tokenizer=None):
        return cls(
            buckets=cfg.TPU.IMAGE_BUCKETS,
            max_gt=cfg.TPU.MAX_GT,
            keypoint_on=cfg.MODEL.KEYPOINT_ON,
            num_keypoints=cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES,
            max_cap_tokens=cfg.TPU.MAX_CAP_TOKENS,
            max_cap_nouns=cfg.TPU.MAX_CAP_NOUNS,
            size_divisible=max(cfg.DATALOADER.SIZE_DIVISIBILITY, 64),
            tokenizer=tokenizer or build_tokenizer(cfg),
        )

    def __call__(self, samples: List[Dict]) -> Dict[str, np.ndarray]:
        b = len(samples)
        hs = [s["image"].shape[0] for s in samples]
        ws = [s["image"].shape[1] for s in samples]
        H, W = select_bucket(
            max(hs), max(ws), self.buckets, self.size_divisible
        )
        m = self.gt_mask_size

        # uint8 when normalization is deferred to the device
        # (INPUT.DEVICE_NORMALIZE): 4x smaller host->HBM transfer
        img_dtype = (
            np.uint8
            if all(s["image"].dtype == np.uint8 for s in samples)
            else np.float32
        )
        images = np.zeros((b, H, W, 3), img_dtype)
        image_sizes = np.zeros((b, 2), np.int32)
        gt_boxes = np.zeros((b, self.max_gt, 4), np.float32)
        gt_labels = np.zeros((b, self.max_gt), np.int32)
        gt_valid = np.zeros((b, self.max_gt), bool)
        gt_masks = np.zeros((b, self.max_gt, m, m), np.float32)
        gt_keypoints = (
            np.zeros((b, self.max_gt, self.num_keypoints, 3), np.float32)
            if self.keypoint_on
            else None
        )
        cap_mask = np.zeros((b,), bool)
        det_mask = np.zeros((b,), bool)
        cap_labels = np.zeros((b, self.max_cap_nouns), np.int32)
        cap_word_valid = np.zeros((b, self.max_cap_nouns), bool)
        cap_tok_ids = np.zeros(
            (b, self.max_cap_nouns, self.noun_token_len), np.int32
        )
        cap_tok_mask = np.zeros(
            (b, self.max_cap_nouns, self.noun_token_len), np.int32
        )
        captions = []
        image_ids = []

        for i, s in enumerate(samples):
            h, w = s["image"].shape[:2]
            images[i, :h, :w] = s["image"]
            image_sizes[i] = (h, w)
            n = min(len(s.get("boxes", [])), self.max_gt)
            if n:
                gt_boxes[i, :n] = s["boxes"][:n]
                gt_labels[i, :n] = s["labels"][:n]
                gt_valid[i, :n] = True
                masks = s.get("gt_masks")
                if masks is not None and len(masks):
                    gt_masks[i, :n] = masks[:n]
                if gt_keypoints is not None:
                    kp = s.get("keypoints")
                    if kp is not None and len(kp):
                        kk = min(kp.shape[1], self.num_keypoints)
                        gt_keypoints[i, :n, :kk] = kp[:n, :kk]
            det_mask[i] = s.get("is_det", "Yes") == "Yes"
            nn_caption = s.get("nn_caption", "")
            cap_mask[i] = nn_caption != ""
            captions.append(s.get("caption", ""))
            image_ids.append(s.get("image_id", i))
            if nn_caption:
                nouns = nn_caption.split("/")[: self.max_cap_nouns]
                ids_cap = list(s.get("ids_cap", []))[: self.max_cap_nouns]
                for j, noun in enumerate(nouns):
                    enc = self.tokenizer.encode(noun, self.noun_token_len)
                    # drop CLS/SEP for the mean-pooled noun embedding
                    real = (
                        enc["attention_mask"]
                        * (1 - enc["special_tokens_mask"])
                    )
                    cap_tok_ids[i, j] = enc["input_ids"]
                    cap_tok_mask[i, j] = real
                    cap_word_valid[i, j] = real.sum() > 0
                    if j < len(ids_cap):
                        cap_labels[i, j] = ids_cap[j]

        cap_enc = self.tokenizer.encode_batch(
            captions, self.max_cap_tokens
        )
        return {
            "images": images,
            "image_sizes": image_sizes,
            "gt_boxes": gt_boxes,
            "gt_labels": gt_labels,
            "gt_valid": gt_valid,
            "gt_masks": gt_masks,
            **(
                {"gt_keypoints": gt_keypoints}
                if gt_keypoints is not None
                else {}
            ),
            "cap_mask": cap_mask,
            "det_mask": det_mask,
            "cap_labels": cap_labels,
            "cap_word_valid": cap_word_valid,
            "cap_tok_ids": cap_tok_ids,
            "cap_tok_mask": cap_tok_mask,
            "input_ids": cap_enc["input_ids"],
            "attention_mask": cap_enc["attention_mask"],
            "special_tokens_mask": cap_enc["special_tokens_mask"],
            "image_ids": np.asarray(image_ids, np.int64),
        }
