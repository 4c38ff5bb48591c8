"""The benchmark's one traffic generator: a mix file in, collated batches
out.

A mix (``benchmark/traffic/<name>.json``) names the loop that drives the
program (``train`` or ``serve``), the batch size, the pool of source
images by size (``[640, 480, 72]`` is 72 images 640 wide and 480 high),
the resize rule and the padded buckets the batches are grouped into
(as ``DATALOADER.GROUP_BY_BUCKET`` groups them), and the annotations of
an image.  Each image is resized as the configs' ``INPUT.MIN_SIZE_*`` /
``MAX_SIZE_*`` rule does it, then falls into the smallest bucket that
holds it; each bucket's images make whole batches.  The pool's
composition is fixed by the mix; the seed draws the images' order and
their contents, so every seed does the same work.  Batches carry the
keys of the program's ``data/collate.py``: uint8 RGB images padded to
the bucket, ``[B, 2]`` sizes, and for training the gt boxes, labels and
28 x 28 masks (up to ``TPU.MAX_GT``) and the caption nouns.  Class
tables come from the seed too: row 0 is the background and zero.
"""

from typing import Dict, List, Tuple

import numpy as np


def resized(w: int, h: int, short: int, longest: int) -> Tuple[int, int]:
    """``(h, w)`` of a ``w`` x ``h`` image after maskrcnn_benchmark's
    ``Resize``: the short side to ``short`` unless the long side would
    pass ``longest``, the other side truncated."""
    lo, hi = min(w, h), max(w, h)
    size = short
    if hi / lo * size > longest:
        size = int(round(longest * lo / hi))
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)


def bucket_for(hw: Tuple[int, int], buckets) -> Tuple[int, int]:
    """The smallest bucket by area that holds ``hw``."""
    fitting = [tuple(b) for b in buckets if b[0] >= hw[0] and b[1] >= hw[1]]
    if not fitting:
        raise ValueError(f"no bucket holds an image of {hw}")
    return min(fitting, key=lambda b: b[0] * b[1])


def pool_images(mix) -> Dict[Tuple[int, int], List[Tuple[int, int]]]:
    """Each bucket's resized image sizes, in the mix's order."""
    short, longest = mix["resize"]
    out: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for w, h, n in mix["image_sizes"]:
        hw = resized(w, h, short, longest)
        out.setdefault(bucket_for(hw, mix["buckets"]), []).extend([hw] * n)
    for bucket, sizes in out.items():
        if len(sizes) % mix["batch"]:
            raise ValueError(f"bucket {bucket} holds {len(sizes)} images, not whole batches of {mix['batch']}")
    return out


def gt_annotations(rng, sizes, mix, classes) -> Dict[str, np.ndarray]:
    """Heavy-tailed gt counts (a log-normal of about COCO's mean, capped
    at ``max_gt``), boxes of log-uniform side inside each image, labels
    of the class table, and elliptic masks in each box's frame."""
    b, g, m = len(sizes), mix["max_gt"], mix["mask_size"]
    mu, sigma = mix["gt_lognormal"]
    count = np.clip(np.ceil(np.exp(rng.normal(mu, sigma, b))), 1, g).astype(np.int64)
    valid = np.arange(g)[None, :] < count[:, None]
    h, w = sizes[:, 0:1].astype(np.float64), sizes[:, 1:2].astype(np.float64)
    lo, hi = mix["gt_side_fraction"]
    side = np.exp(rng.uniform(np.log(lo), np.log(hi), (b, g)))  # of the image's sides
    bw = np.clip(side * w * rng.uniform(0.6, 1.4, (b, g)), 8, w - 2)
    bh = np.clip(side * h * rng.uniform(0.6, 1.4, (b, g)), 8, h - 2)
    x1 = rng.uniform(0, 1, (b, g)) * (w - bw - 1)
    y1 = rng.uniform(0, 1, (b, g)) * (h - bh - 1)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32) * valid[..., None]
    grid = (np.arange(m) + 0.5) / m - 0.5
    rx = rng.uniform(0.2, 0.5, (b, g, 1, 1))
    ry = rng.uniform(0.2, 0.5, (b, g, 1, 1))
    masks = (grid[None, None, None, :] / rx) ** 2 + (grid[None, None, :, None] / ry) ** 2 <= 1
    return dict(
        gt_boxes=boxes,
        gt_labels=(rng.integers(1, classes, (b, g)) * valid).astype(np.int32),
        gt_valid=valid,
        gt_masks=(masks & valid[..., None, None]).astype(np.float32),
    )


def caption_nouns(rng, b, mix, lvis) -> Dict[str, np.ndarray]:
    """1 to ``max_nouns`` caption nouns an image, each 1 to 3 wordpieces
    between CLS and SEP, with an LVIS label."""
    n, t = mix["max_nouns"], mix["noun_tokens"]
    lo, hi = mix["noun_wordpieces"]
    nouns = rng.integers(1, n + 1, b)
    word_valid = np.arange(n)[None, :] < nouns[:, None]
    pieces = rng.integers(lo, hi + 1, (b, n))
    pos = np.arange(t)[None, None, :]
    tok_mask = (pos >= 1) & (pos <= pieces[..., None]) & word_valid[..., None]
    return dict(
        cap_mask=np.ones((b,), bool),
        det_mask=np.ones((b,), bool),
        cap_tok_ids=np.where(tok_mask, rng.integers(1000, mix["vocab"], (b, n, t)), 0).astype(np.int32),
        cap_tok_mask=tok_mask.astype(np.int32),
        cap_word_valid=word_valid,
        cap_labels=(rng.integers(0, lvis, (b, n)) * word_valid).astype(np.int32),
    )


def class_tables(rng, config) -> Dict[str, np.ndarray]:
    """The dataset's class table (and the LVIS table where the model has
    a caption branch), ``[rows, emb_dim]`` float32 of N(0, 1 / emb_dim),
    rows of about unit norm as averaged BERT word vectors have; row 0
    (the background) zero."""
    d = config["model"]["emb_dim"]
    std = np.float32(d ** -0.5)
    classes = rng.standard_normal((config["class_rows"], d)).astype(np.float32) * std
    classes[0] = 0.0
    out = {"class_embeddings": classes}
    if config.get("lvis_rows"):
        out["lvis_class_embeddings"] = rng.standard_normal((config["lvis_rows"], d)).astype(np.float32) * std
    return out


def pool_batches(rng, mix) -> List[Tuple[Tuple[int, int], np.ndarray]]:
    """``(bucket, [B, 2] sizes)`` of each batch: every bucket's images
    shuffled and cut into batches, the batches in the seed's order."""
    b = mix["batch"]
    batches = []
    for bucket, sizes in sorted(pool_images(mix).items()):
        sizes = np.asarray(sizes, np.int32)[rng.permutation(len(sizes))]
        batches += [(bucket, sizes[i:i + b]) for i in range(0, len(sizes), b)]
    return [batches[i] for i in rng.permutation(len(batches))]


def make_pool(seed: int, mix, config) -> Tuple[List[Dict[str, np.ndarray]], Dict[str, np.ndarray]]:
    """``(batches, tables)`` for one run: the pool in the seed's order and
    the class tables."""
    rng = np.random.default_rng(seed)
    tables = class_tables(rng, config)
    b = mix["batch"]
    batches = []
    for hw, sizes in pool_batches(rng, mix):
        images = np.zeros((b, hw[0], hw[1], 3), np.uint8)
        for i, (h, w) in enumerate(sizes):
            images[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        batch = {"images": images, "image_sizes": sizes}
        if mix["loop"] == "train":
            batch.update(gt_annotations(rng, sizes, mix, config["class_rows"]))
            if config.get("lvis_rows"):
                batch.update(caption_nouns(rng, b, mix, config["lvis_rows"]))
        batches.append(batch)
    return batches, tables
