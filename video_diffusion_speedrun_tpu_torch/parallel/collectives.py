"""Collectives (port of `parallel/collectives.py`).

The JAX package leaves in-program collectives to GSPMD; what host code
needs is a scalar average and a barrier. The port also reduces the
gradients itself after `backward`, where GSPMD inserts the reduction in
JAX: a sum over the context group (each rank holds its own tokens' share),
a sum over the tensor group (for replicated leaves used inside the tensor
region) and a mean over the data group; a gradient that is a DTensor (an
FSDP2 or tensor-parallel shard) is reduced through its local shard. Each
is a no-op in a world of one.

Inside the model, the three operators of Megatron-style tensor
parallelism (`models/dit.py`), each a `torch.autograd.Function` over the
tensor group:

- `copy_to_region`: identity forward, all-reduce (sum) backward — the
  input of a column-parallel product, replicated over the group, whose
  gradient each rank holds a share of;
- `reduce_from_region`: all-reduce forward, identity backward — the
  partial output of a row-parallel product;
- `gather_from_region`: all-gather along the last dim forward, this rank's
  slice backward — a column-parallel output that every rank needs whole
  (the AdaLN modulation). Every rank then computes the same gradient of
  the whole, so the backward needs no communication.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def avg_scalar_across_hosts(value: float) -> float:
    """Mean of a host-local Python scalar over all processes."""
    if _world() == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=_device())
    dist.all_reduce(t)
    return float(t.item()) / _world()


def barrier() -> None:
    """Host barrier, as `dist.barrier()`; for host-side I/O."""
    if _world() > 1:
        dist.barrier()


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, or the tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def all_reduce_(tensors: Sequence[Optional[torch.Tensor]], group,
                mean: bool = False) -> None:
    """Sum (or average) `tensors` over `group` in place, as one flat fp32
    buffer; None entries (a leaf outside the graph, the same on every rank)
    are skipped. A DTensor is reduced through its local shard, which holds
    the same part of the tensor on every rank of `group`. A None group is
    a no-op."""
    if group is None:
        return
    live = [local(t) for t in tensors if t is not None]
    if not live:
        return
    flat = torch.cat([t.reshape(-1).float() for t in live])
    dist.all_reduce(flat, group=group)
    if mean:
        flat /= dist.get_world_size(group)
    offset = 0
    for t in live:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view(t.shape))
        offset += n


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        size = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[-1]
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.width, ctx.width), None


def copy_to_region(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the gradient over `group` (None: x)."""
    return x if group is None else _CopyToRegion.apply(x, group)


def reduce_from_region(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`; the backward passes the gradient on
    (None: x)."""
    return x if group is None else _ReduceFromRegion.apply(x, group)


def gather_from_region(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' x joined along the last dim in rank order; the backward
    keeps this rank's columns (None: x)."""
    return x if group is None else _GatherFromRegion.apply(x, group)
