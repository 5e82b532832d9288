"""Host-side collectives (port of `parallel/collectives.py`).

The JAX package leaves in-program collectives to GSPMD; what host code
needs is a scalar average and a barrier. The port also reduces the
gradients itself after `backward`, where GSPMD inserts the reduction in
JAX: a sum over the context group (each rank holds its own tokens' share)
and a mean over the data group. Each is a no-op in a world of one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


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


def all_reduce_(tensors: Sequence[Optional[torch.Tensor]], group,
                mean: bool = False) -> None:
    """Sum (or average) `tensors` over `group` in place, as one flat fp32
    buffer; None entries (a leaf outside the graph, the same on every rank)
    are skipped. A None group is a no-op."""
    if group is None:
        return
    live = [t for t in tensors if t is not None]
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
