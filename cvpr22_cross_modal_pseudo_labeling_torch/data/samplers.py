"""Index samplers: distributed sharding, aspect-ratio grouping,
iteration-based wrapping, repeat-factor rebalancing.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
samplers.py``.

Re-designs of reference data/samplers/ (distributed.py:10-66,
grouped_batch_sampler.py:9-115, iteration_based_batch_sampler.py) and
the OpenImages repeat-factor logic (openimages.py:154-234).
"""

import math
from typing import Iterator, List, Optional, Sequence

import numpy as np


class DistributedSampler:
    """Pad-to-divisible, per-rank contiguous slice, epoch-seeded shuffle
    (distributed.py semantics).  On TPU 'rank' is the process index
    (multi-host) — within one host the global batch is sharded on the
    mesh instead."""

    def __init__(
        self,
        dataset_len: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        repeat_factors: Optional[np.ndarray] = None,
        pad: bool = True,
    ):
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.repeat_factors = repeat_factors
        # pad=False: exact rank::num_replicas striping with ragged
        # shards — required for eval, where padding duplicates boundary
        # images and a prediction gather would double-count them
        self.pad = pad

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        rng = np.random.RandomState(self.seed + self.epoch)
        if self.repeat_factors is not None:
            # stochastic rounding of repeat factors per epoch
            # (openimages repeat-factor sampling)
            rf = np.asarray(self.repeat_factors)
            ints = np.floor(rf).astype(np.int64)
            frac = rf - ints
            extra = (rng.rand(len(rf)) < frac).astype(np.int64)
            idx = np.repeat(np.arange(len(rf)), ints + extra)
        else:
            idx = np.arange(self.dataset_len)
        if self.shuffle:
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[int]:
        idx = self._epoch_indices()
        if not self.pad:
            return iter(idx[self.rank :: self.num_replicas].tolist())
        total = int(
            math.ceil(len(idx) / self.num_replicas) * self.num_replicas
        )
        if total > len(idx):
            idx = np.concatenate([idx, idx[: total - len(idx)]])
        per = total // self.num_replicas
        shard = idx[self.rank * per : (self.rank + 1) * per]
        return iter(shard.tolist())

    def __len__(self):
        n = (
            len(self.repeat_factors)
            if self.repeat_factors is not None
            else self.dataset_len
        )
        return int(math.ceil(n / self.num_replicas))


class GroupedBatchSampler:
    """Batches only within aspect-ratio groups (portrait vs landscape,
    grouped_batch_sampler.py; group ids from data/build.py
    _quantize(aspect_ratios, [1])).  Never-exhausted leftovers are
    emitted as trailing partial batches unless drop_last."""

    def __init__(
        self,
        sampler,
        group_ids: Sequence[int],
        batch_size: int,
        drop_last: bool = False,
    ):
        self.sampler = sampler
        self.group_ids = np.asarray(group_ids)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        buffers = {}
        for idx in self.sampler:
            g = int(self.group_ids[idx])
            buffers.setdefault(g, []).append(idx)
            if len(buffers[g]) == self.batch_size:
                yield buffers.pop(g)
        if not self.drop_last:
            for g in sorted(buffers):
                if buffers[g]:
                    yield buffers[g]

    def __len__(self):
        return int(math.ceil(len(self.sampler) / self.batch_size))


class IterationBasedBatchSampler:
    """Re-iterates the wrapped batch sampler until num_iterations
    (iteration_based_batch_sampler.py); resumable from start_iter."""

    def __init__(self, batch_sampler, num_iterations: int, start_iter: int = 0):
        self.batch_sampler = batch_sampler
        self.num_iterations = num_iterations
        self.start_iter = start_iter

    def __iter__(self):
        iteration = self.start_iter
        while iteration < self.num_iterations:
            # epoch seed = the RUNNING iteration at each epoch start
            # (iteration_based_batch_sampler.py:22-23 passes the
            # iteration, not an epoch ordinal, to set_epoch): a resumed
            # run reshuffles from where it crashed instead of replaying
            # the epoch-0/1/2 orders it already consumed
            if hasattr(self.batch_sampler, "sampler") and hasattr(
                self.batch_sampler.sampler, "set_epoch"
            ):
                self.batch_sampler.sampler.set_epoch(iteration)
            start = iteration
            for batch in self.batch_sampler:
                if iteration >= self.num_iterations:
                    return
                yield batch
                iteration += 1
            if iteration == start:
                # a grouped sampler that drops its partial batches yields
                # nothing when no group holds a batch's worth of images:
                # the next epoch would be as empty, for ever
                raise ValueError(
                    "the batch sampler yielded no batch in a whole epoch (no aspect-ratio or "
                    "bucket group holds SOLVER.IMS_PER_BATCH images?); set "
                    "DATALOADER.ASPECT_RATIO_GROUPING False or use more images"
                )

    def __len__(self):
        return self.num_iterations - self.start_iter


def compute_aspect_ratio_groups(dataset) -> List[int]:
    """data/build.py:71-113 _compute_aspect_ratios + _quantize([1])."""
    groups = []
    for i in range(len(dataset)):
        info = dataset.get_img_info(i)
        h, w = info.get("height", 0), info.get("width", 1)
        groups.append(1 if h and w and h / max(w, 1) >= 1 else 0)
    return groups


def compute_bucket_groups(
    dataset,
    buckets,
    min_size: int,
    max_size: int,
    size_divisible: int = 64,
) -> List[int]:
    """Group id = which TPU image bucket the image's resized shape
    selects (data/collate.py:select_bucket), so GroupedBatchSampler
    emits bucket-homogeneous batches and per-batch padding is minimal.

    This generalizes the reference's binary aspect grouping
    (data/build.py:71-113 _quantize([1])): Resize keeps aspect, so
    every bucket class is a (finer) aspect class, and the per-batch
    padding tax drops from the widest-member bucket to the image's own
    bucket.  Extra buckets cost nothing until a batch actually lands
    on them (XLA compiles per encountered shape).

    ``min_size`` is the canonical (first) INPUT.MIN_SIZE_TRAIN; with
    multi-scale training the runtime bucket can differ per draw — the
    collator still pads whatever arrives correctly, grouping is only a
    batching heuristic.
    """
    import logging

    from .collate import select_bucket
    from .transforms import get_resize_hw

    bucket_ids = {tuple(b): i for i, b in enumerate(buckets)}
    # images larger than every bucket get select_bucket's divisible-pad
    # fallback of their OWN dims — grouping all of them together would
    # make every distinct overflow-batch composition a fresh compiled
    # shape, so each fallback (H, W) gets its own group id instead
    overflow_ids: dict = {}
    groups = []
    degenerate = 0
    for i in range(len(dataset)):
        info = dataset.get_img_info(i)
        h, w = info.get("height", 0), info.get("width", 1)
        if not (h and w):
            degenerate += 1
            nh, nw = get_resize_hw(
                (min_size, min_size), min_size, max_size
            )
        else:
            nh, nw = get_resize_hw((h, w), min_size, max_size)
        sel = tuple(select_bucket(nh, nw, buckets, size_divisible))
        gid = bucket_ids.get(sel)
        if gid is None:
            gid = overflow_ids.setdefault(
                sel, len(bucket_ids) + len(overflow_ids)
            )
        groups.append(gid)
    if overflow_ids or degenerate:
        logging.getLogger(__name__).warning(
            "bucket grouping: %d overflow shape(s) beyond the "
            "IMAGE_BUCKETS ladder (%s)%s — each adds one compiled train "
            "program; extend TPU.IMAGE_BUCKETS to cover them",
            len(overflow_ids),
            sorted(overflow_ids),
            f"; {degenerate} image(s) had degenerate metadata"
            if degenerate
            else "",
        )
    return groups
