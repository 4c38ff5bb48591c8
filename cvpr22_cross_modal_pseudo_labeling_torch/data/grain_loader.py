"""The grain stream (``DATALOADER.USE_GRAIN``), without grain.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
grain_loader.py``.  That loader builds a grain ``MapDataset`` pipeline::

    source (repeat factors expanded) -> slice(shard_index, None, shard_count)
      -> seed(GRAIN_SEED).shuffle() -> repeat(None) -> batch(drop_remainder)
      -> slice(start_iter, MAX_ITER) -> iterator with {"next_index": k}

and the port computes the same stream in plain Python, record for
record, so that a resume is a slice of it:

* record ``g`` of the stream is record ``i`` of epoch ``e``
  (``divmod(g, n)`` over the shard's ``n`` records), which the shuffle
  puts at ``index_shuffle(i, n - 1, (seed + e) mod 2**32, rounds=4) +
  e * n`` (``data/index_shuffle.py``; the seed is derived from
  ``GRAIN_SEED`` as grain derives it), then taken modulo ``n`` by the
  source;
* batch ``b`` of the stream holds records ``[b * bs, (b + 1) * bs)``, so
  a batch may span two epochs and hold one record twice;
* the iterator's state is grain's dict ``{"next_index": k}``: the
  batches handed to the consumer, not those read ahead, so a state
  written by the JAX package's loader restores unchanged.

Reads run ``max(prefetch_batches, num_threads)`` batches ahead on a
thread pool, each batch read and collated on one thread, as grain's
``ReadOptions`` do; the order does not depend on the thread count.  As
in the JAX package, batches are not grouped by bucket: a mixed batch
rides its largest member's bucket.
"""

import math
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logger import get_logger
from .index_shuffle import U32, index_shuffle, shuffle_seed


class _RobustIndexedSource:
    """Random-access source yielding (dataset_index, sample); a corrupt
    sample falls back to the next dataset index (the threaded loader's
    soft-failure policy)."""

    def __init__(self, dataset, index_map: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.index_map = np.asarray(index_map, np.int64) if index_map is not None else None

    def __len__(self) -> int:
        return len(self.index_map) if self.index_map is not None else len(self.dataset)

    def __getitem__(self, i: int) -> Tuple[int, dict]:
        idx = int(self.index_map[i]) if self.index_map is not None else int(i)
        try:
            return idx, self.dataset[idx]
        except Exception as e:
            get_logger("data").warning(
                "sample %d failed (%s: %s); substituting neighbor", idx, type(e).__name__, e,
            )
            idx = (idx + 1) % len(self.dataset)
            return idx, self.dataset[idx]


def _expand_repeat_factors(repeat_factors: Sequence[float]) -> List[int]:
    """Each index ``floor(rf)`` times, once more when the fraction is at
    least 0.5, and at least once (deterministic, unlike the threaded
    sampler's stochastic rounding)."""
    out: List[int] = []
    for i, rf in enumerate(repeat_factors):
        n = int(math.floor(rf))
        if rf - n >= 0.5:
            n += 1
        out.extend([i] * max(n, 1))
    return out


class GrainIterator:
    """One pass over a ``GrainLoader``'s batches with grain's state:
    ``get_state()`` is ``{"next_index": k}``, the count of batches
    handed out; ``set_state`` moves the pass to another batch."""

    def __init__(self, loader: "GrainLoader"):
        self._loader = loader
        self._next = 0
        self._ahead: deque = deque()  # (batch index, future), in order
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()

    def __iter__(self):
        return self

    def _fill(self):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self._loader.num_threads, thread_name_prefix="grain-read")
        first = self._ahead[-1][0] + 1 if self._ahead else self._next
        for j in range(first, min(self._next + self._loader.read_ahead, len(self._loader))):
            self._ahead.append((j, self._pool.submit(self._loader.read_batch, j)))

    def __next__(self):
        with self._lock:
            if self._next >= len(self._loader):
                self.close()
                raise StopIteration
            self._fill()
            j, future = self._ahead.popleft()
            assert j == self._next
            item = future.result()
            self._next += 1
            self._fill()
            return item

    def get_state(self) -> dict:
        return {"next_index": self._next}

    def set_state(self, state: dict) -> None:
        with self._lock:
            self._drop()
            self._next = int(state["next_index"])

    def _drop(self):
        while self._ahead:
            self._ahead.popleft()[1].cancel()

    def close(self):
        if sys.is_finalizing():
            return
        self._drop()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):
        self.close()


class GrainLoader:
    """Iterable of (batch_dict, dataset_indices) batches, the threaded
    loader's contract.  A training loader (``num_iters`` given) keeps one
    iterator across ``__iter__`` calls, whose ``get_state``/``set_state``
    make the stream checkpointable; an eval loader starts a fresh pass
    on each ``__iter__``."""

    def __init__(
        self,
        dataset,
        collator,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_iters: Optional[int] = None,
        start_iter: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
        drop_last: bool = True,
        num_threads: int = 8,
        prefetch_batches: int = 4,
        repeat_factors: Optional[Sequence[float]] = None,
    ):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive.")
        index_map = _expand_repeat_factors(repeat_factors) if repeat_factors is not None else None
        self._source = _RobustIndexedSource(dataset, index_map)
        self._collator = collator
        self.batch_size = batch_size
        n_source = len(self._source)
        if shard_count > 1:
            # the shard's records, sliced before the shuffle
            self._records = np.arange(*slice(shard_index, None, shard_count).indices(n_source), dtype=np.int64)
        else:
            self._records = np.arange(n_source, dtype=np.int64)
        n = len(self._records)
        self._seed = shuffle_seed(seed) if shuffle else None
        self._repeat = num_iters is not None
        self._start = 0
        if num_iters is not None:
            # infinite epochs, bounded by the batch-level slice
            self._start = start_iter
            self._len = max(num_iters - start_iter, 0) if n else 0
        else:
            self._len = n // batch_size if drop_last else math.ceil(n / batch_size)
        self.num_threads = max(int(num_threads), 1)
        # grain caps usable threads at the buffer size
        self.read_ahead = max(prefetch_batches, self.num_threads)
        self._it: Optional[GrainIterator] = None
        self._persistent = num_iters is not None

    def __len__(self) -> int:
        return self._len

    def record_indices(self, j: int) -> np.ndarray:
        """The source indices of the loader's batch ``j``."""
        n = len(self._records)
        b = self._start + j
        first = b * self.batch_size
        last = first + self.batch_size if self._repeat else min(n, first + self.batch_size)
        g = np.arange(first, last, dtype=np.int64)
        if self._seed is not None:
            epochs, within = np.divmod(g, n)
            shuffled = np.empty_like(g)
            for e in np.unique(epochs):
                sel = epochs == e
                shuffled[sel] = index_shuffle(within[sel], n - 1, (self._seed + int(e)) & U32, 4) + int(e) * n
            g = shuffled
        return self._records[g % n]

    def read_batch(self, j: int):
        samples = [self._source[int(i)] for i in self.record_indices(j)]
        return self._collator([s for _, s in samples]), [i for i, _ in samples]

    def example_batch(self):
        """One collated batch from the dataset head, without touching the
        checkpointable iterator."""
        n = min(self.batch_size, len(self._source))
        samples = [self._source[i] for i in range(n)]
        return self._collator([s for _, s in samples]), [i for i, _ in samples]

    def iterator(self) -> GrainIterator:
        """The live iterator (made on first use)."""
        if self._it is None:
            self._it = GrainIterator(self)
        return self._it

    def __iter__(self) -> Iterator:
        it = self.iterator() if self._persistent else GrainIterator(self)
        try:
            yield from it
        finally:
            if not self._persistent:
                it.close()

    # -- data-stream checkpointing ------------------------------------
    def get_state(self):
        return self.iterator().get_state()

    def set_state(self, state) -> None:
        self.iterator().set_state(state)


def make_grain_loader(cfg, dataset, collator, is_train: bool, start_iter: int = 0, shard_index: int = 0,
                      shard_count: int = 1) -> GrainLoader:
    """The config's grain loader: the global batch split over the shards,
    ``GRAIN_SEED``, ``MAX_ITER`` and ``DROP_LAST`` for training; the test
    batch, in order, with the tail, for evaluation."""
    if is_train:
        return GrainLoader(
            dataset, collator,
            batch_size=cfg.SOLVER.IMS_PER_BATCH // max(shard_count, 1),
            shuffle=True,
            seed=cfg.DATALOADER.GRAIN_SEED,
            num_iters=cfg.SOLVER.MAX_ITER,
            start_iter=start_iter,
            shard_index=shard_index,
            shard_count=shard_count,
            drop_last=cfg.DATALOADER.DROP_LAST,
            num_threads=max(cfg.DATALOADER.NUM_WORKERS, 1),
            repeat_factors=getattr(dataset, "repeat_factors", None),
        )
    return GrainLoader(
        dataset, collator,
        batch_size=cfg.TEST.IMS_PER_BATCH // max(shard_count, 1),
        shuffle=False,
        seed=cfg.DATALOADER.GRAIN_SEED,
        num_iters=None,
        shard_index=shard_index,
        shard_count=shard_count,
        drop_last=False,
        num_threads=max(cfg.DATALOADER.NUM_WORKERS, 1),
    )
