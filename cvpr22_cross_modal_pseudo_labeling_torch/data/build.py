"""Data loader construction.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
build.py``, on its threaded path.  The loader yields the numpy batches
that ``engine/inference.py::Predictor`` and ``engine/train_step.py::
device_batch`` take; its producer thread and decode pool touch numpy
only, so every CUDA call stays on the caller's thread.  Every factory
of the JAX package is built, the VOC and Cityscapes ones included;
``DATALOADER.USE_GRAIN`` builds the grain stream of ``data/grain_loader.py``
instead of the threaded loader, for training and for test.

Re-design of reference data/build.py:18-192 (make_data_loader): catalog
lookup -> dataset factory -> transforms -> sampler stack (distributed
shard, aspect-ratio grouping, iteration wrapping, repeat factors) ->
threaded prefetching loader producing statically-shaped batch dicts.

The torch DataLoader worker-pool is replaced by a thread-pool prefetcher
(images decode under PIL/cv2 which release the GIL) with a bounded
queue.
"""

import logging
import os
import queue
import threading
from typing import Iterator, Optional

from .collate import BatchCollator
from .datasets import (
    CityScapesDataset,
    COCOCapDetDataset,
    COCOCaptionsDataset,
    COCODataset,
    ConCapDetDataset,
    ConcatDataset,
    ConceptualCaptionsDataset,
    ConceptualOpenImagesDetDataset,
    ListDataset,
    OpenImagesDataset,
    PascalVOCDataset,
)
from .samplers import (
    DistributedSampler,
    GroupedBatchSampler,
    IterationBasedBatchSampler,
    compute_aspect_ratio_groups,
    compute_bucket_groups,
)
from .transforms import build_transforms

DATASET_CLASSES = {
    "COCODataset": COCODataset,
    "COCOCapDetDataset": COCOCapDetDataset,
    "COCOCaptionsDataset": COCOCaptionsDataset,
    "ConCapDetDataset": ConCapDetDataset,
    "ConceptualCaptionsDataset": ConceptualCaptionsDataset,
    "ListDataset": ListDataset,
    "OpenImagesDataset": OpenImagesDataset,
    "PascalVOCDataset": PascalVOCDataset,
    "CityScapesDataset": CityScapesDataset,
}


def load_paths_catalog(cfg):
    """Imports the dataset catalog module from cfg.PATHS_CATALOG by file
    path (reference defaults.py:571 + utils/imports.py import_file), so
    deployments can swap dataset roots without touching the package."""
    from . import paths_catalog as default_catalog

    path = getattr(cfg, "PATHS_CATALOG", "") or ""
    if (
        not path
        or not os.path.exists(path)
        or os.path.abspath(path) == os.path.abspath(
            default_catalog.__file__
        )
    ):
        return default_catalog
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "cmpl_tpu_paths_catalog", path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_dataset(cfg, dataset_names, transforms, is_train: bool):
    """data/build.py:18-63: catalog entries -> dataset instances,
    concatenated for training.  The Conceptual/OpenImages mixture builds
    the two catalog entries it names (JAX's :85-88)."""
    import inspect

    paths_catalog = load_paths_catalog(cfg)

    def instantiate(name):
        entry = paths_catalog.DatasetCatalog.get(name)
        factory_name = entry["factory"]
        args = dict(entry["args"])
        if factory_name == "ConceptualOpenImagesDetDataset":
            det = instantiate(args.pop("det_name"))
            cap = instantiate(args.pop("cap_name"))
            return ConceptualOpenImagesDetDataset(det, cap)
        factory = DATASET_CLASSES.get(factory_name)
        if factory is None:
            raise KeyError(
                f"dataset {name}: the {factory_name} factory is no dataset of the JAX package; "
                f"the port builds {sorted(DATASET_CLASSES)} and ConceptualOpenImagesDetDataset"
            )
        args["transforms"] = transforms
        args["extra_args"] = dict(cfg.DATASETS.DATASET_ARGS)
        # a factory without the empty-image filter does not take it
        # (JAX's per-factory arg plumbing, data/build.py:95-104)
        if "remove_images_without_annotations" in inspect.signature(factory.__init__).parameters:
            args.setdefault("remove_images_without_annotations", is_train)
        return factory(**args)

    datasets = [instantiate(name) for name in dataset_names]
    if not is_train:
        return datasets
    return [datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)]


class _ProducerError:
    """Carrier for an exception raised inside the producer thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchingLoader:
    def __init__(self, dataset, batch_sampler, collator, num_workers=4):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collator = collator
        self.num_workers = max(num_workers, 1)

    def __len__(self):
        return len(self.batch_sampler)

    def _fetch(self, idx: int):
        """Per-sample soft failure handling (the reference drops bad
        batches with a logged error, trainer.py:96-98 / inference.py:61-67;
        here a corrupt sample falls back to a neighboring index)."""
        try:
            return self.dataset[idx]
        except Exception as e:  # corrupt image/annotation
            logging.getLogger(__name__).warning(
                "sample %d failed (%s: %s); substituting neighbor",
                idx, type(e).__name__, e,
            )
            return self.dataset[(idx + 1) % len(self.dataset)]

    def example_batch(self):
        """One collated batch built synchronously from the head of the
        sampler, WITHOUT starting the prefetch thread or consuming the
        training stream — used for parameter init (tools/train_net.py).
        Falls back to the dataset head when the sampler is already
        exhausted (a completed run relaunched: start_iter == MAX_ITER
        makes IterationBasedBatchSampler empty)."""
        first_idx = next(iter(self.batch_sampler), None)
        if first_idx is None:
            bs_obj = self.batch_sampler
            while not hasattr(bs_obj, "batch_size") and hasattr(
                bs_obj, "batch_sampler"
            ):
                bs_obj = bs_obj.batch_sampler
            bs = getattr(bs_obj, "batch_size", 1)
            first_idx = [i % len(self.dataset) for i in range(bs)]
        samples = [self._fetch(i) for i in first_idx]
        return self.collator(samples), list(first_idx)

    def __iter__(self) -> Iterator:
        out_q: "queue.Queue" = queue.Queue(maxsize=4)
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that gives up once the consumer is gone, so
            an abandoned iterator (e.g. islice'd val-loss passes) never
            leaves the producer parked forever in Queue.put."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in self.batch_sampler:
                        if stop.is_set():
                            return
                        samples = list(
                            pool.map(self._fetch, batch_idx)
                        )
                        if not _put(
                            (self.collator(samples), list(batch_idx))
                        ):
                            return
            except BaseException as e:
                # surface sampler/collator/double-fetch failures to the
                # consumer instead of masquerading as end-of-stream
                # (the bare `finally: put(None)` made any producer
                # exception look like a clean, early exhaustion)
                _put(_ProducerError(e))
            finally:
                _put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, _ProducerError):
                    raise RuntimeError(
                        "data loader producer thread failed"
                    ) from item.exc
                yield item
        finally:
            stop.set()


def make_data_loader(
    cfg,
    is_train: bool = True,
    is_distributed: bool = False,
    start_iter: int = 0,
    rank: int = 0,
    num_replicas: int = 1,
):
    """data/build.py:115-192. Returns one loader for training, a list
    for test."""
    num_hosts = num_replicas if is_distributed else 1
    if is_train:
        global_batch = cfg.SOLVER.IMS_PER_BATCH
        per_host = global_batch // num_hosts
        shuffle = True
        num_iters = cfg.SOLVER.MAX_ITER
        names = cfg.DATASETS.TRAIN
    else:
        per_host = cfg.TEST.IMS_PER_BATCH // num_hosts
        shuffle = False
        num_iters = None
        names = cfg.DATASETS.TEST

    transforms = build_transforms(cfg, is_train)
    datasets = build_dataset(cfg, names, transforms, is_train)
    collator = BatchCollator.from_cfg(cfg)

    loaders = []
    for ds in datasets:
        if cfg.DATALOADER.USE_GRAIN:
            from .grain_loader import make_grain_loader

            loaders.append(
                make_grain_loader(cfg, ds, collator, is_train, start_iter=start_iter, shard_index=rank,
                                  shard_count=num_hosts)
            )
            continue
        repeat = getattr(ds, "repeat_factors", None)
        sampler = DistributedSampler(
            len(ds),
            num_replicas=num_hosts,
            rank=rank,
            shuffle=shuffle,
            repeat_factors=repeat if is_train else None,
            pad=is_train,
        )
        if cfg.DATALOADER.ASPECT_RATIO_GROUPING and is_train:
            group_drop_last = cfg.DATALOADER.DROP_LAST
            if cfg.DATALOADER.GROUP_BY_BUCKET and cfg.TPU.IMAGE_BUCKETS:
                # bucket-homogeneous batches: minimal padding per batch.
                # Multi-scale training: group by the LARGEST configured
                # min size — any smaller draw of the same image fits the
                # same bucket, so the compiled-shape set stays bounded
                # by len(buckets) (each batch's max dims select at most
                # that group's bucket).
                ms = cfg.INPUT.MIN_SIZE_TRAIN
                ms_list = list(ms) if isinstance(ms, (tuple, list)) else [ms]
                if len(ms_list) > 1:
                    logger = logging.getLogger(__name__)
                    logger.info(
                        "GROUP_BY_BUCKET with multi-scale MIN_SIZE_TRAIN "
                        "%s: grouping by the largest scale (%d) to bound "
                        "padding and compiled shapes",
                        ms_list, max(ms_list),
                    )
                groups = compute_bucket_groups(
                    ds,
                    cfg.TPU.IMAGE_BUCKETS,
                    min_size=max(ms_list),
                    max_size=cfg.INPUT.MAX_SIZE_TRAIN,
                    size_divisible=max(cfg.DATALOADER.SIZE_DIVISIBILITY, 64),
                )
                # the ladder has up to len(buckets)+overflow groups; with
                # drop_last=False each epoch flushes that many partial
                # batches of ARBITRARY size, and every new (batch, rung)
                # pair is a fresh XLA compile of the train step.  Force
                # drop_last so exactly len(buckets) train programs ever
                # compile (training is iteration-based + shuffled, the
                # dropped tail differs every epoch).
                if not group_drop_last:
                    logging.getLogger(__name__).info(
                        "GROUP_BY_BUCKET forces DROP_LAST=True to keep "
                        "the compiled train-program count at "
                        "len(IMAGE_BUCKETS)"
                    )
                    group_drop_last = True
            else:
                groups = compute_aspect_ratio_groups(ds)
            batch_sampler = GroupedBatchSampler(
                sampler, groups, per_host, drop_last=group_drop_last
            )
        else:
            batch_sampler = _FixedBatchSampler(
                sampler, per_host,
                drop_last=cfg.DATALOADER.DROP_LAST and is_train,
            )
        if num_iters is not None:
            batch_sampler = IterationBasedBatchSampler(
                batch_sampler, num_iters, start_iter
            )
        loaders.append(
            PrefetchingLoader(
                ds, batch_sampler, collator, cfg.DATALOADER.NUM_WORKERS
            )
        )
    if is_train:
        assert len(loaders) == 1
        return loaders[0], datasets[0]
    return loaders, datasets


class _FixedBatchSampler:
    def __init__(self, sampler, batch_size, drop_last=False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        import math

        n = len(self.sampler)
        return (
            n // self.batch_size
            if self.drop_last
            else math.ceil(n / self.batch_size)
        )
