"""Data parallelism across processes: one process a device.

The port's counterpart of ``distillclip_tpu/parallel/mesh.py``.  The JAX
package shards the batch over a device mesh and lets XLA insert the
collectives; here ``torchrun`` (or any launcher that sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) starts
one process a device, :func:`initialize_distributed` joins them in a
``torch.distributed`` process group (NCCL on CUDA devices, gloo on the CPU),
and the tasks call the collectives below explicitly.

**The data-parallel rule (sum).**  Every rank computes the whole global loss:
the tasks gather every tensor the loss reads over the ranks, the students'
with :func:`gather_with_grad` and the teachers' with :func:`all_gather`, in
rank order, and evaluate the loss on the global batch, so that every rank
holds the same loss and the same metrics.  The backward of
:func:`gather_with_grad` returns the rank's own slice of the incoming
gradient, with no collective, so each rank's parameter gradient is its
samples' share of the global loss's gradient; :func:`all_reduce_gradients`
then **sums** the shares, and every rank applies the same update to the same
masters.  Parameters that act on the gathered tensors (a loss's own, such
as ``vit_kd``'s) get their whole gradient on every rank and are not summed.
The step of W ranks on local batches of B is so the single-process step on
the global batch of W·B: the same loss, updated masters and ``grad_norm``.
(The other rule, a gather whose backward all-reduces and gradients
averaged, would scale this gradient by 1/W or W if mixed with it.)

Work that one rank does for all, the teacher's pre-encoding of a corpus
(an hour and more on ImageNet-scale corpora), runs through
:func:`on_first_rank`: the others wait for its outcome on a gloo group of
their own with a week's timeout, not in a collective of the process group,
whose 600 s would abort them.

Nothing falls back: a launcher's ``WORLD_SIZE`` > 1 whose process group
cannot form raises, and a process group is never formed quietly on another
device.  The tensor-parallel ``model`` axis of the JAX mesh and its kernel
sharding (``ops/_shard.py``) have no counterpart here.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Callable, Dict, List

import torch
import torch.distributed as dist

_BUCKET_ELEMENTS = 1 << 25      # 128 MiB of fp32 a gradient all-reduce


def env_world_size() -> int:
    """The launcher's ``WORLD_SIZE`` (1 when unset)."""
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


_TIMEOUT = timedelta(seconds=600)
_FIRST_RANK_TIMEOUT = timedelta(days=7)     # in effect none: as long as the work takes
_wait_group = None


def initialize_distributed(device="cuda", force: bool = False) -> bool:
    """Join the launcher's processes in one process group; False (and
    nothing done) for a single process, unless ``force`` (a group of one, so
    that the collectives run).  ``device`` is the run's device type: ``cuda``
    selects NCCL on ``cuda:LOCAL_RANK``, ``cpu`` gloo.  Idempotent."""
    if dist.is_initialized():
        return True
    world = env_world_size()
    if world <= 1 and not force:
        return False
    missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE={world} without {missing}: start the processes with "
                           "torchrun, or set the variables it sets")
    kind = torch.device(device).type
    if kind == "cuda":
        if torch.cuda.device_count() <= local_rank():
            raise RuntimeError(f"LOCAL_RANK={local_rank()}: this machine has "
                               f"{torch.cuda.device_count()} CUDA devices")
        torch.cuda.set_device(local_rank())
        backend = "nccl"
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no data-parallel backend for device type {kind!r}")
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        world_size=world, rank=int(os.environ["RANK"]), timeout=_TIMEOUT)
    global _wait_group
    _wait_group = dist.new_group(backend="gloo", timeout=_FIRST_RANK_TIMEOUT)
    return True


def active() -> bool:
    """True inside a process group: the tasks gather and sum through it
    (with a group of one too, where each collective is a copy)."""
    return dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing for a single process)."""
    if world_size() > 1:
        dist.barrier()


def on_first_rank(fn: Callable[[], None]) -> None:
    """Run ``fn`` on the first rank while the others wait, however long it
    takes (module docstring); a failure there raises on every rank."""
    if world_size() <= 1:
        fn()
        return
    error, outcome = None, [None]
    if is_main():
        try:
            fn()
        except Exception as e:      # every rank must hear of it before it is raised
            error, outcome[0] = e, f"{type(e).__name__}: {e}"
    dist.broadcast_object_list(outcome, src=0, group=_wait_group)
    if error is not None:
        raise error
    if outcome[0] is not None:
        raise RuntimeError(f"the first rank failed: {outcome[0]}")


def _gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` of every rank, concatenated along ``dim`` in rank order.  gloo
    gathers bf16 as fp32 (exact both ways)."""
    wire = x.float() if x.dtype == torch.bfloat16 and x.device.type == "cpu" else x
    parts = [torch.empty_like(wire) for _ in range(world_size())]
    dist.all_gather(parts, wire.contiguous())
    return torch.cat(parts, dim=dim).to(x.dtype)


class _GatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        return _gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        # the sum rule: this rank's slice, no collective
        return grad.narrow(ctx.dim, rank() * ctx.size, ctx.size), None


def gather_with_grad(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``x`` (``[B_local, ...]`` along ``dim``) of every rank concatenated in
    rank order, differentiable: the gradient returns this rank's slice
    (module docstring: the sum rule).  The identity outside a process group."""
    if not active():
        return x
    return _GatherWithGrad.apply(x, dim)


def all_gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The same without a gradient (teachers' representations, the eval
    step's representations)."""
    if not active():
        return x
    with torch.no_grad():
        return _gather(x.detach(), dim)


def _buckets(names: List[str], grads: Dict[str, torch.Tensor]) -> List[List[str]]:
    out, size = [[]], 0
    for k in names:
        if out[-1] and size + grads[k].numel() > _BUCKET_ELEMENTS:
            out.append([])
            size = 0
        out[-1].append(k)
        size += grads[k].numel()
    return out


@torch.no_grad()
def all_reduce_gradients(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The sum over the ranks of each gradient, in place: the leaves are
    packed into flat buffers of at most 2^25 elements (one collective a
    bucket, not one a parameter), summed, and unpacked.  Every rank ends
    with the same bits."""
    if not active():
        return grads
    names = sorted(grads)
    for bucket in _buckets(names, grads):
        flat = torch.cat([grads[k].reshape(-1) for k in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        offset = 0
        for k in bucket:
            n = grads[k].numel()
            grads[k].copy_(flat[offset:offset + n].view_as(grads[k]))
            offset += n
    return grads


def all_equal(value: torch.Tensor) -> bool:
    """True when ``value`` holds the same bits on every rank (a check the
    data-parallel tools run on the masters)."""
    if not active():
        return True
    gathered = _gather(value.detach().contiguous().reshape(1, -1).view(torch.uint8), 0)
    return bool((gathered == gathered[:1]).all())


def shard_kwargs() -> dict:
    """The loader's shard of this process: ``{}`` for one process, else
    ``{"num_shards": world_size(), "shard_index": rank()}``.  A launcher's
    ``WORLD_SIZE`` > 1 without a process group is an error: every process
    would otherwise train on the whole epoch."""
    if world_size() > 1:
        return {"num_shards": world_size(), "shard_index": rank()}
    if env_world_size() > 1:
        raise RuntimeError(f"WORLD_SIZE={env_world_size()} but no process group is "
                           "initialised: call parallel.initialize_distributed(device) first "
                           "(the CLI does)")
    return {}


def process_device(device) -> torch.device:
    """``device`` as this process's device: ``cuda`` is ``cuda:LOCAL_RANK``
    when running data-parallel."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None and world_size() > 1:
        return torch.device("cuda", local_rank())
    return d
