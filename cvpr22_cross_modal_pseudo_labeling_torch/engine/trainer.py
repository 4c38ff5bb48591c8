"""The training loop.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/engine/
trainer.py`` (reference engine/trainer.py:54-267, ``do_train``): the
iteration body is one ``step_fn`` call (``Trainer.train_step``); the
host loop feeds batches that are already on the device, keeps at most
two steps in flight, logs windowed metrics with an ETA, checkpoints,
runs the periodic evaluation and stops on a non-finite loss.

* :class:`SummaryWriter` writes ``tb/metrics.jsonl`` always, and
  TensorBoard events when ``tensorboard`` imports.
* :class:`DevicePrefetcher` is a double buffer: the loader's thread
  turns each numpy batch into pinned CPU tensors; the main thread
  issues their copies on a side CUDA stream one batch ahead, and the
  step's stream waits on the copy's event.  Every CUDA call but the
  pinning stays on the main thread.  On the CPU it passes batches
  through.
* :func:`do_train` takes ``step_fn(batch) -> metrics``, so that a caller
  can replay fixed random draws through it.
* On more than one rank (``parallel/dist.py``) every rank runs the loop on
  its rows of each global batch; the metrics (already the global batch's)
  go to TensorBoard from rank 0 only, each rank keeps its own
  loader-state file, and the checkpoint is written and published by rank
  0 (``engine/checkpoint.py``); every rank leaves the loop after the
  final save is published.
"""

import datetime
import json
import os
import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..parallel.dist import barrier, is_primary, rank, world_size
from ..utils.logger import get_logger
from ..utils.metric_logger import MetricLogger
from .checkpoint import (
    checkpoint_state,
    discard_pending_checkpoint,
    flush_pending_checkpoint,
    pending_checkpoint_step,
    save_checkpoint,
)


class SummaryWriter:
    """Metrics sink: JSONL always; TensorBoard events when the
    ``tensorboard`` package is there (replaces tensorboardX,
    train_net.py:223-228)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter as TensorBoardWriter
        except ImportError:
            return
        self._tb = TensorBoardWriter(log_dir)

    def write(self, step: int, metrics: Dict[str, float]):
        self._jsonl.write(json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}}) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def _as_tensors(batch) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v) for k, v in batch.items() if isinstance(v, np.ndarray)}


class DevicePrefetcher:
    """Double-buffered upload of the loader's batches to ``device``.

    ``convert(batch)`` turns a numpy batch into CPU tensors (default:
    every array); ``extra`` holds device tensors added to every batch
    (the class tables).  On CUDA a thread draws from the loader and pins
    each converted batch; :meth:`__next__`, on the caller's thread,
    issues the next batch's non-blocking copies on a side stream before
    it hands over the current one, makes the current stream wait on the
    current batch's copy event, and keeps each pinned batch alive until
    its copy has completed.  Queue depth 2, as in JAX.  On the CPU the
    batches pass through, converted.
    """

    _SENTINEL = object()

    def __init__(self, loader, device, convert: Optional[Callable] = None, extra=None, depth: int = 2):
        self.device = torch.device(device)
        self._convert = convert or _as_tensors
        self._extra = dict(extra or {})
        self._loader = loader
        self._cuda = self.device.type == "cuda"
        self._err = None
        self._last_state = None
        self._stop = threading.Event()
        if not self._cuda:
            self._it = iter(loader)
            return
        self._q = queue.Queue(maxsize=depth)
        self._stream = torch.cuda.Stream(self.device)
        self._next = None  # (device batch, copy event, pinned batch, loader state)
        self._copies = deque()  # (copy event, pinned batch) until the copy completes
        self._thread = threading.Thread(target=self._run, name="device-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Enqueue with stop-polling: the producer must never block
        forever on a full queue once the consumer has stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        # checkpointable streams: snapshot the position right after each
        # batch, so the state saved with iteration k resumes at batch k+1
        get_state = getattr(self._loader, "get_state", None)
        try:
            for batch, _ in self._loader:
                if self._stop.is_set():
                    return
                pinned = {k: t.pin_memory() for k, t in self._convert(batch).items()}
                state = get_state() if get_state else None
                if not self._put((pinned, state)):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._put(self._SENTINEL)

    def _issue(self, block: bool):
        """Starts the copies of the loader's next batch on the side stream
        (waiting for the batch only when ``block``); False at the end of
        the stream or when no batch is ready."""
        try:
            item = self._q.get(block=block)
        except queue.Empty:
            return False
        if item is self._SENTINEL:
            self._q.put(item)  # seen again by the next call
            return False
        pinned, state = item
        with torch.cuda.stream(self._stream):
            dev = {k: t.to(self.device, non_blocking=True) for k, t in pinned.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        self._next = (dev, event, pinned, state)
        self._copies.append((event, pinned))
        return True

    def __iter__(self):
        return self

    def __next__(self):
        if not self._cuda:
            batch, _ = next(self._it)
            state_fn = getattr(self._loader, "get_state", None)
            self._last_state = state_fn() if state_fn else None
            return {**self._convert(batch), **self._extra}
        while self._copies and self._copies[0][0].query():
            self._copies.popleft()
        if self._next is None and not self._issue(block=True):
            if self._err is not None:
                raise self._err
            raise StopIteration
        dev, event, _, state = self._next
        self._next = None
        self._issue(block=False)  # the next batch's copy overlaps this step
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for t in dev.values():
            t.record_stream(current)  # allocated on the side stream, used on this one
        if state is not None:
            self._last_state = state
        return {**dev, **self._extra}

    def get_state(self):
        """Stream position as of the last batch handed to the consumer
        (None for non-checkpointable loaders)."""
        return self._last_state

    def stop(self):
        self._stop.set()
        if not self._cuda:
            return
        # drop queued batches so their buffers free promptly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._next = None


def _host_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The 0-d metrics on the host, in one copy."""
    keys = [k for k, v in metrics.items() if v.dim() == 0]
    if not keys:
        return {}
    values = torch.stack([metrics[k].detach().to(torch.float32) for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


def do_train(
    step_fn: Callable,
    trainer,
    loader,
    cfg,
    eval_fn: Optional[Callable] = None,
    output_dir: Optional[str] = None,
    start_iter: int = 0,
):
    """Runs the training loop from ``start_iter`` to ``SOLVER.MAX_ITER``;
    returns ``trainer``.

    ``step_fn(batch)`` takes one batch on the device and returns the
    metrics as 0-d tensors.  ``trainer`` (a ``Trainer``) gives the
    device, the batch conversion (``host_batch``), the tables on the
    device (``class_tables``) and the checkpointed state.
    ``eval_fn(trainer, iteration)`` is called every ``TEST_PERIOD``.
    """
    logger = get_logger("trainer")
    meters = MetricLogger()
    output_dir = output_dir or cfg.OUTPUT_DIR
    writer = SummaryWriter(os.path.join(output_dir, "tb")) if is_primary() else None
    max_iter = cfg.SOLVER.MAX_ITER
    log_period = cfg.SOLVER.LOG_PERIOD
    ckpt_period = cfg.SOLVER.CHECKPOINT_PERIOD
    test_period = cfg.SOLVER.TEST_PERIOD
    abort_non_finite = cfg.SOLVER.ABORT_ON_NON_FINITE

    if start_iter >= max_iter:
        # a completed run relaunched in the same OUTPUT_DIR trains zero
        # steps (reference trainer.py:94 never enters the loop)
        logger.info(
            "training already complete (iteration %d >= MAX_ITER %d); nothing to do", start_iter, max_iter,
        )
        if writer:
            writer.close()
        return trainer

    cuda = trainer.device.type == "cuda"
    iteration = start_iter
    last_finite_iter = start_iter
    prefetcher = DevicePrefetcher(loader, trainer.device, trainer.host_batch, trainer.class_tables)
    # at most two steps in flight: the loop runs ahead of the device by
    # one step and never further (JAX's bounded pipelining)
    inflight = deque()
    try:
        end = time.perf_counter()
        for batch in prefetcher:
            data_time = time.perf_counter() - end

            metrics = step_fn(batch)
            if cuda:
                event = torch.cuda.Event()
                event.record()
                inflight.append(event)
                if len(inflight) > 2:
                    inflight.popleft().synchronize()
            iteration += 1

            # the step is asynchronous: one iteration's time is the
            # host's; the sum over the run is the sustained figure, and
            # sum(data) / sum(time) the host's data-wait share
            meters.update(time=time.perf_counter() - end, data=data_time)

            if iteration % log_period == 0 or iteration == max_iter:
                metrics = _host_metrics(metrics)
                total = metrics.get("total_loss")
                if abort_non_finite and total is not None and not np.isfinite(total):
                    # blow-ups stop the job; the last good checkpoint stays
                    logger.error(
                        "non-finite total_loss %s at iteration %d; aborting "
                        "(set SOLVER.ABORT_ON_NON_FINITE False to continue through divergence)",
                        total, iteration,
                    )
                    # publish the pending save ONLY if it strictly
                    # predates the last finite loss: the save at k holds
                    # post-update-k weights, which only a finite loss
                    # after k validates
                    pending = pending_checkpoint_step()
                    if pending is not None and pending >= last_finite_iter:
                        logger.warning(
                            "dropping pending checkpoint at iteration %d (after last finite loss at %d "
                            "-- may hold diverged weights)", pending, last_finite_iter,
                        )
                        discard_pending_checkpoint()
                    else:
                        flush_pending_checkpoint()
                    raise FloatingPointError(f"non-finite total_loss at iteration {iteration}: {metrics}")
                if total is not None:
                    last_finite_iter = iteration
                meters.update(**metrics)
                eta = datetime.timedelta(seconds=int(meters.meters["time"].global_avg * (max_iter - iteration)))
                logger.info("iter %d/%d eta %s %s", iteration, max_iter, eta, meters)
                if writer:
                    writer.write(iteration, metrics)
            if ckpt_period and iteration % ckpt_period == 0 and output_dir:
                # pipelined: the write overlaps the next steps and is
                # published by the next save or the final flush; the
                # stream position is staged with it
                save_checkpoint(
                    output_dir, checkpoint_state(trainer, iteration), iteration, block=False,
                    extras=_loader_state_extras(output_dir, prefetcher),
                )
            if test_period and eval_fn and iteration % test_period == 0:
                eval_fn(trainer, iteration)
            end = time.perf_counter()
            if iteration >= max_iter:
                # never step past MAX_ITER, whatever the loader still holds
                break
    finally:
        prefetcher.stop()
        if writer:
            writer.close()

    if output_dir:
        if pending_checkpoint_step() != iteration:
            save_checkpoint(
                output_dir, checkpoint_state(trainer, iteration), iteration,
                extras=_loader_state_extras(output_dir, prefetcher),
            )
        flush_pending_checkpoint()
        barrier()  # the final save is published before any rank goes on
    steps = iteration - start_iter
    if steps > 0:
        # sustained summary (reference logs the totals at
        # engine/trainer.py:261-266)
        t = meters.meters["time"]
        d = meters.meters["data"]
        logger.info(
            "sustained: %d steps, %.1f s wall, %.3f s/it, %.2f imgs/s/host, data-wait %.1f%% "
            "(sum_data %.1f s / sum_time %.1f s)",
            steps, t.total, t.total / steps, cfg.SOLVER.IMS_PER_BATCH // world_size() * steps / t.total,
            100.0 * d.total / max(t.total, 1e-9), d.total, t.total,
        )
    return trainer


def loader_state_path(output_dir: str) -> str:
    """This rank's data-stream position's file: each rank reads its own
    shard of the stream."""
    r = rank()
    return os.path.join(output_dir, "loader_state.json" if r == 0 else f"loader_state_{r}.json")


def _loader_state_extras(output_dir: str, loader):
    """Snapshot of the data-stream position, serialized now (at the
    checkpoint's iteration) and handed to save_checkpoint as a staged
    sidecar, written only when the save publishes.  None for the
    threaded loader, whose resume is start_iter fast-forwarding."""
    get_state = getattr(loader, "get_state", None)
    if get_state is None:
        return None
    try:
        state = get_state()
        if state is None:  # nothing consumed yet, or not checkpointable
            return None
        return {loader_state_path(output_dir): json.dumps(state)}
    except (TypeError, ValueError) as e:
        get_logger("trainer").warning("loader state not captured: %s", e)
        return None


def restore_loader_state(output_dir: str, loader) -> bool:
    """Restores a saved data-stream position; True when the loader
    resumed mid-stream."""
    set_state = getattr(loader, "set_state", None)
    path = loader_state_path(output_dir)
    if set_state is None or not os.path.exists(path):
        return False
    try:
        with open(path) as f:
            set_state(json.load(f))
        return True
    except (OSError, ValueError) as e:
        get_logger("trainer").warning("loader state not restored: %s", e)
        return False


def tokenize_class_names(class_names, tokenizer, token_len: int = 8):
    """Tokenize class names into (ids, mask) int32 [C, T] for
    extract_word_embeddings; empty/"bg" names get all-zero rows (their
    embedding comes out zero, the background convention)."""
    ids = np.zeros((len(class_names), token_len), np.int32)
    mask = np.zeros((len(class_names), token_len), np.int32)
    for i, name in enumerate(class_names):
        if not name or name == "bg":
            continue
        enc = tokenizer.encode(name, token_len)
        real = enc["attention_mask"] * (1 - enc["special_tokens_mask"])
        ids[i] = enc["input_ids"]
        mask[i] = real
    return ids, mask


@torch.no_grad()
def compute_class_name_embeddings(model, class_names, tokenizer, token_len: int = 8) -> np.ndarray:
    """BERT-table mean embeddings for a list of class names
    (st_generalized_rcnn.py:202-209 extract_emb), computed once on the
    model's device by ``STGeneralizedRCNN.extract_word_embeddings``.
    Returns [C, emb_dim] L2-normalized (zero rows for empty names, e.g.
    background)."""
    ids, mask = tokenize_class_names(class_names, tokenizer, token_len)
    device = model.bert.word_embeddings.device
    out = model.extract_word_embeddings(
        torch.from_numpy(ids).to(device, torch.int64), torch.from_numpy(mask).to(device)
    )
    return out.cpu().numpy()
