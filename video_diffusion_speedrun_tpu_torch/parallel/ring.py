"""The ring of context parallelism: how k/v chunks travel between ranks.

The counterpart of the JAX package's `_ring_perm` / `_pp`
(`ops/fused_attention.py:1305-1311`, a `ppermute` over the mesh's context
axis). The ring attention (`ops/fused_attention.py:_RingFlash`) sees one
small interface:

- `size`: the number of ranks cp; `ranks`: the ranks this process holds;
- `split(x, dim)` / `join(parts, dim)`: a local tensor to the chunks of
  those ranks, and back;
- `shift(per_rank)`: each held rank's tuple of tensors goes to rank + 1,
  each receives rank − 1's;
- `local(x, dim)` / `gather(x)`: a tensor of the whole padded token axis to
  the local tensor, and back (the gather's backward keeps the local rows:
  every rank computes the same loss from the same gathered output);
- `gather_kv(x, dim)`: the local tensor gathered whole for every rank to
  read (the k and v of the gathered attention under context parallelism,
  `models/dit.py`); its backward sums the ranks' gradients of the whole
  and keeps this rank's rows (a reduce-scatter).

Two rings implement it:

- `DistRing(group)`: one rank per process, `dist.batch_isend_irecv` on the
  mesh's context group (NCCL on cards, gloo on the CPU);
- `LocalRing(cp)`: all cp ranks in one process. Its local tensor is the
  whole padded axis; it runs each rank's schedule in turn, so the kernels
  launch at the true per-rank chunk shapes, in the same ring order and with
  the same merges as `DistRing`, and a shift is a rotation of the list of
  chunks. It lets one card drive the ring kernels, as the JAX tests' 8
  virtual CPU devices do. It is only ever chosen explicitly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

Chunks = List[Tuple[torch.Tensor, ...]]


class LocalRing:
    """cp ranks in one process; no communication."""

    group = None

    def __init__(self, cp: int):
        if cp < 1:
            raise ValueError(f"a ring needs at least one rank, got {cp}")
        self.size = cp
        self.ranks = tuple(range(cp))

    def split(self, x: torch.Tensor, dim: int = 1) -> List[torch.Tensor]:
        return list(x.chunk(self.size, dim=dim))

    def join(self, parts: Sequence[torch.Tensor], dim: int = 1
             ) -> torch.Tensor:
        return torch.cat(list(parts), dim=dim)

    def shift(self, per_rank: Chunks) -> Chunks:
        return per_rank[-1:] + per_rank[:-1]

    def local(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def gather_kv(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return x


class _Gather(torch.autograd.Function):
    """All-gather of each rank's chunk along dim 1; the backward keeps this
    rank's rows of the gradient (no sum: every rank computes the same loss
    on the same gathered output)."""

    @staticmethod
    def forward(ctx, x, ring):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(ring.size)]
        dist.all_gather(parts, x, group=ring.group)
        ctx.rank, ctx.rows = ring.rank, x.shape[1]
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.rank * ctx.rows, ctx.rows), None


class _GatherSummed(torch.autograd.Function):
    """All-gather of each rank's chunk along `dim`, read by every rank;
    the backward sums the ranks' gradients of the whole onto each rank's
    chunk (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, ring, dim):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(ring.size)]
        dist.all_gather(parts, x, group=ring.group)
        ctx.group, ctx.dim = ring.group, dim
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        parts = [c.contiguous() for c in g.chunk(n, ctx.dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter_tensor(out.view(-1),
                                   torch.cat([c.view(-1) for c in parts]),
                                   group=ctx.group)
        return out, None, None


class DistRing:
    """One rank of a ring over a process group (the mesh's context axis)."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = (self.rank,)
        members = dist.get_process_group_ranks(group)
        self._next = members[(self.rank + 1) % self.size]
        self._prev = members[(self.rank - 1) % self.size]

    def split(self, x: torch.Tensor, dim: int = 1) -> List[torch.Tensor]:
        return [x]

    def join(self, parts: Sequence[torch.Tensor], dim: int = 1
             ) -> torch.Tensor:
        (x,) = parts
        return x

    def shift(self, per_rank: Chunks) -> Chunks:
        (tensors,) = per_rank
        sends = [t.contiguous() for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, self._next, self.group)
               for t in sends]
        ops += [dist.P2POp(dist.irecv, t, self._prev, self.group)
                for t in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [tuple(recvs)]

    def local(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        rows = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * rows, rows)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(x, self)

    def gather_kv(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return _GatherSummed.apply(x, self, dim)
