"""Data parallelism over processes: one rank a card, launched by torchrun.

Counterpart of the data axis of ``cvpr22_cross_modal_pseudo_labeling_tpu/
parallel/mesh.py``.  JAX runs one SPMD program over a mesh whose ``data``
axis shards the global batch; the port runs one process a rank, each on
its rows of the global batch, and reduces what JAX's program reduces over
that axis:

* the gradients, through ``DistributedDataParallel`` with :func:`sum_hook`
  (``engine/train_step.py``);
* the loss normalizers, counts over the global batch, through
  :func:`global_sum` (the RPN, box, mask, keypoint, RetinaNet and WSDDN
  losses, the uncertainty weight, MMSS's MLM count and hits);
* the rows a rank's share of a loss reads from every rank, through
  :func:`gather_rows_grad`, whose backward reduces the gradient back to
  each rank's rows (MMSS: the grounding head's v2l-projected images and
  region masks and its ``[B_local, B]`` costs, the transformer head's
  visual tokens, region masks and pair scores), and the ceilings of
  MMSS's guards and masks, through :func:`global_max`;
* draws every rank must share (MMSS's random triplet negatives), through
  :func:`from_primary`;
* the exemplar table's candidates, through :func:`gather_rows` in rank
  order, which is JAX's global image order;
* the evaluation's results, through :func:`gather_objects` (the JAX
  package's ``gather_objects``).

Every helper is the identity, or a no-op, when no process group is up or
it holds one rank, so that a one-process run computes exactly what it
computed before.  ``TPU.MESH_AXES`` and its ``model`` axis are accepted
and ignored: only the data axis is ported.
"""

import os
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def init_from_env(backend: str = "nccl", device_type: str = "cuda") -> torch.device:
    """Joins the process group torchrun's environment describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    returns this rank's device: ``cuda:LOCAL_RANK`` (modulo the cards
    present, so that ranks may share a card over gloo), made current, or
    the CPU for ``device_type="cpu"``.  A group already up (joined by the
    caller, e.g. through a ``file://`` rendezvous) is kept.  Any failure
    raises: no backend stands in for another."""
    if backend not in BACKENDS:
        raise ValueError(f"dist backend {backend!r}: one of {BACKENDS}")
    local = int(os.environ.get("LOCAL_RANK", 0))
    device = torch.device("cpu")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_from_env: no CUDA device is available")
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs CUDA devices; pass --dist-backend gloo for the CPU")
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, as a new tensor without gradient; ``x``
    itself with one rank.  Every rank must call it at the same point with
    the same shape."""
    if world_size() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along the
    first axis in rank order, without gradient; ``x`` itself with one
    rank (:func:`gather_rows_grad` of ``x.detach()``)."""
    w = world_size()
    if w == 1:
        return x
    return gather_rows_grad(x.detach(), [x.shape[0]] * w)


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The largest element of ``x`` over every rank, 0-d and without
    gradient (``x.max()`` with one rank).  Every rank must call it at the
    same point."""
    out = x.detach().max()
    if world_size() > 1:
        out = out.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


def from_primary(x: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``x`` on every rank (the same shape on each), without
    gradient; ``x`` itself with one rank.  A draw every rank must share
    comes from rank 0's generator."""
    if world_size() == 1:
        return x
    out = x.detach().clone() if rank() == 0 else torch.zeros_like(x)
    dist.all_reduce(out)
    return out


def row_counts(n: int, device=None) -> List[int]:
    """Every rank's row count ``n``, in rank order; ``[n]`` with one rank."""
    if world_size() == 1:
        return [n]
    return [int(c) for c in gather_rows(torch.tensor([n], dtype=torch.int64, device=device)).tolist()]


def _reduce_dtype(dtype: torch.dtype) -> torch.dtype:
    # bool as uint8 (gloo sums no bool); 16-bit floats in float32, so that
    # the backward's sum of the ranks' gradients rounds once
    if dtype == torch.bool:
        return torch.uint8
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _padded_sum(rows: Sequence[torch.Tensor], counts: Sequence[int], like: torch.Tensor) -> torch.Tensor:
    """The all-reduced ``[world, max(counts), ...]`` buffer in which rank
    i's block holds ``rows[i]`` (a None entry stays zero): a gather as a
    sum with zeros, which is exact, since gloo reduces CUDA tensors but
    gathers none."""
    buf = torch.zeros((len(counts), max(counts), *like.shape[1:]), dtype=_reduce_dtype(like.dtype),
                      device=like.device)
    for i, x in enumerate(rows):
        if x is not None:
            buf[i, :x.shape[0]] = x
    dist.all_reduce(buf)
    return buf


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, counts):
        ctx.counts, ctx.dtype = counts, x.dtype
        r = rank()
        buf = _padded_sum([x.detach() if i == r else None for i in range(len(counts))], counts, x)
        if min(counts) == max(counts):
            out = buf.reshape(-1, *x.shape[1:])
        else:
            out = torch.cat([buf[i, :c] for i, c in enumerate(counts)])
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        # each rank's share of the loss reads every gathered row, so the
        # gradient of rank r's rows is the sum of the ranks' gradients of
        # them: an all-reduce, then this rank's block (a reduce-scatter)
        counts, r = ctx.counts, rank()
        buf = _padded_sum(list(torch.split(grad, list(counts))), counts, grad)
        return buf[r, :counts[r]].to(ctx.dtype), None


def gather_rows_grad(x: torch.Tensor, counts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every rank's rows of ``x`` concatenated along the first axis in
    rank order, with a gradient: ``[sum(counts), ...]``, where rank i
    holds ``counts[i]`` rows (:func:`row_counts`, gathered here when None;
    the other axes alike on every rank).  Each rank's block is padded to
    the largest count for the all-reduce and the padding dropped, so that
    a short rank's padded rows never enter the result.  The backward
    all-reduces the incoming gradient and keeps this rank's block: the
    gradient of each rank's rows sums over every rank's share of the loss.
    ``x`` itself with one rank, so that a one-process graph is unchanged.
    Every rank must call it at the same point, forward and backward."""
    if world_size() == 1:
        return x
    if counts is None:
        counts = row_counts(x.shape[0], x.device)
    counts = tuple(int(c) for c in counts)
    if counts[rank()] != x.shape[0]:
        raise ValueError(f"gather_rows_grad: rank {rank()} has {x.shape[0]} rows, its count is {counts[rank()]}")
    return _GatherRows.apply(x, counts)


def gather_objects(obj: Any) -> List[Any]:
    """``[obj of rank 0, ..., obj of rank w-1]`` on every rank (picklable
    objects: COCO result dicts, proposals, metrics); ``[obj]`` with one
    rank.  A failure raises: a result that silently lacks another rank's
    share would be scored as the whole."""
    w = world_size()
    if w == 1:
        return [obj]
    out: List[Any] = [None] * w
    dist.all_gather_object(out, obj)
    return out


def sum_hook(process_group, bucket):
    """DDP communication hook: the bucket's gradients summed over the
    ranks, not averaged.  Each rank's loss is its share of a loss
    normalized over the global batch, so the global gradient is the sum
    of the ranks' gradients; the default hook would divide it by the
    world size."""
    group = process_group if process_group is not None else dist.group.WORLD
    fut = dist.all_reduce(bucket.buffer(), group=group, async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])
