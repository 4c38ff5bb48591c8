"""Data parallelism over processes: one rank a card, launched by torchrun.

Counterpart of the data axis of ``cvpr22_cross_modal_pseudo_labeling_tpu/
parallel/mesh.py``.  JAX runs one SPMD program over a mesh whose ``data``
axis shards the global batch; the port runs one process a rank, each on
its rows of the global batch, and reduces what JAX's program reduces over
that axis:

* the gradients, through ``DistributedDataParallel`` with :func:`sum_hook`
  (``engine/train_step.py``);
* the loss normalizers, counts over the global batch, through
  :func:`global_sum` (the RPN, box and mask losses, the uncertainty
  weight);
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
from typing import Any, List

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


def refuse_ranks(what: str, why: str = "its loss normalizers count this rank's rows, not the global batch's") -> None:
    """Raises NotImplementedError on more than one rank for a loss that
    the port does not yet compute over the global batch, as JAX's sharded
    step does: its gradient would be another model's."""
    if world_size() > 1:
        raise NotImplementedError(
            f"{what} on {world_size()} ranks: {why} (ROADMAP.md queue A item 8); train it in one process"
        )


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along the
    first axis in rank order; ``x`` itself with one rank.  An all-reduce
    of a zero-filled ``[world, ...]`` buffer in which each rank fills its
    own row: gloo reduces CUDA tensors but gathers none, and a sum with
    zeros is exact."""
    w = world_size()
    if w == 1:
        return x
    dtype = torch.uint8 if x.dtype == torch.bool else x.dtype
    buf = torch.zeros((w, *x.shape), dtype=dtype, device=x.device)
    buf[rank()] = x.detach()
    dist.all_reduce(buf)
    return buf.reshape(w * x.shape[0], *x.shape[1:]).to(x.dtype)


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
