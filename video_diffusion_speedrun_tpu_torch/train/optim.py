"""muP AdamW (port of `train/optim.py`).

`MupAdamW` holds the per-leaf muP (lr, wd) table, the Adam moments (fp32,
or bf16 storage when `moments_dtype` is set; the math is fp32 either way)
and the step count. `step(grads)` applies the JAX `fused_apply` update
with t = count + 1: bc1 = 1 − b1^t, bc2 = 1 − b2^t, lr_t = λ(count), then
updates parameters and moments in place — where the TPU kernel aliases
its inputs to its outputs (`input_output_aliases`), the port writes the
same buffers. On CUDA that is one launch of the multi-tensor kernel over
every leaf; on the CPU the plain twin runs leaf by leaf.

Sharded parameters (DTensors of FSDP2 or the tensor axis,
`parallel/fsdp.py`) keep their moments as DTensors of the same placement;
the update runs on each rank's local shards, the muP table reads the
global shapes. The kernel's table of leaf pointers is built at the first
step (after FSDP2 has settled its sharded storage) and again after
`refresh()`, which a checkpoint load calls.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

from video_diffusion_speedrun_tpu_torch.core.config import OptimizerConfig
from video_diffusion_speedrun_tpu_torch.ops.fused_adamw import (
    MultiTensorAdamW,
    adamw_leaf_update_plain,
    step_scalars,
)
from video_diffusion_speedrun_tpu_torch.parallel.collectives import local
from video_diffusion_speedrun_tpu_torch.train.mup import mup_table
from video_diffusion_speedrun_tpu_torch.train.schedules import get_schedule


def _zeros_like(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Zeros of p's shape in `dtype`; a DTensor's zeros are a DTensor of
    its placement, made from zeros of its local shard."""
    if not isinstance(p, DTensor):
        return torch.zeros_like(p, dtype=dtype)
    return DTensor.from_local(torch.zeros_like(p.to_local(), dtype=dtype),
                              p.device_mesh, p.placements, run_check=False,
                              shape=p.shape, stride=p.stride())


class MupAdamW:
    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 learning_rate: float, max_steps: int,
                 cfg: Optional[OptimizerConfig] = None):
        cfg = cfg or OptimizerConfig()
        named = list(named_params)
        self.cfg = cfg
        self.names = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        self.settings = mup_table(named, learning_rate, cfg.weight_decay, cfg)
        self.lrs = [self.settings[n]["lr"] for n in self.names]
        self.wds = [self.settings[n]["wd"] for n in self.names]
        self.schedule = get_schedule(cfg.scheduler, cfg.warmup_steps,
                                     max_steps)
        with torch.no_grad():
            self.m = [_zeros_like(p, cfg.moments_dtype or p.dtype)
                      for p in self.params]
            self.v = [_zeros_like(m, m.dtype) for m in self.m]
        self.count = 0
        self._zero_grads = {}  # leaf index → zeros, for leaves with no grad
        self._kernel = None  # built at the next step on CUDA leaves

    def leaves(self):
        """The local shards (p, m, v) of every leaf, in order."""
        return ([local(p).detach() for p in self.params],
                [local(m) for m in self.m], [local(v) for v in self.v])

    @staticmethod
    def kernel_for(params):
        """The multi-tensor kernel's wrapper for these local leaves: CUDA
        leaves take it, CPU leaves the plain twin (None)."""
        return MultiTensorAdamW if params[0].is_cuda else None

    def refresh(self) -> None:
        """Rebuild the kernel's leaf table at the next step: call after
        anything that may have moved the parameters' or moments' storage
        (a checkpoint load)."""
        self._kernel = None

    def lr_scale(self) -> float:
        """λ at the current count: the multiplier of the next update."""
        return self.schedule(self.count)

    def _grad(self, i: int, g: Optional[torch.Tensor]) -> torch.Tensor:
        # a leaf outside the graph (block 0's λ: it never mixes v0) gets a
        # zero gradient, as JAX's `jnp.where` gives it
        if g is None:
            g = self._zero_grads.get(i)
            if g is None:
                g = self._zero_grads[i] = torch.zeros_like(
                    local(self.params[i]))
        return local(g)

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """One update from `grads` (one per parameter, in order; None is a
        zero gradient). Advances the count."""
        cfg = self.cfg
        grads = [self._grad(i, g) for i, g in enumerate(grads)]
        lr_t, bc1, bc2 = step_scalars(self.count, self.lr_scale(), cfg.beta1,
                                      cfg.beta2)
        params, ms, vs = self.leaves()
        if self._kernel is None:
            kernel = self.kernel_for(params)
            if kernel is not None:
                self._kernel = kernel(params, ms, vs, self.lrs, self.wds,
                                      cfg.beta1, cfg.beta2, cfg.eps)
        if self._kernel is not None:
            self._kernel(grads, lr_t, bc1, bc2)
        else:
            for p, m, v, g, lr, wd in zip(params, ms, vs, grads, self.lrs,
                                          self.wds):
                adamw_leaf_update_plain(p, m, v, g, lr, wd, lr_t, bc1, bc2,
                                        cfg.beta1, cfg.beta2, cfg.eps)
        self.count += 1
