"""muP AdamW (port of `train/optim.py`).

`MupAdamW` holds the per-leaf muP (lr, wd) table, the Adam moments (fp32,
or bf16 storage when `moments_dtype` is set; the math is fp32 either way)
and the step count. `step(grads)` applies the JAX `fused_apply` update
with t = count + 1: bc1 = 1 − b1^t, bc2 = 1 − b2^t, lr_t = λ(count), then
updates parameters and moments in place — where the TPU kernel aliases
its inputs to its outputs (`input_output_aliases`), the port writes the
same buffers. On CUDA that is one launch of the multi-tensor kernel over
every leaf; on the CPU the plain twin runs leaf by leaf.

The optimizer-in-backward step (`train/inloop.py`) updates one group of
leaves at a time — a block (`blocks.<i>`), or the layers before and
after the blocks (`rest`) — with `update_group`, and advances the count
once per step (`advance`); each group's update is one launch of the
kernel over its exact leaves, its table built once. Parameters may then
be bf16 (the kernel's bf16 mode), and with `nu_factored` the block
weights of at least `nu_factored_min_size` elements over all blocks
(JAX's stacked leaf, `inloop.py:159-168`) keep Adafactor's rank-1 ν
(`FNu`, fp32 factors) instead of v. A group's factored leaves take their
own kernel on CUDA (`FactoredAdamW`: two launches, the sums of g² and then
the update; XLA work in JAX, not a Pallas kernel), the plain twin
`factored_leaf_update` on the CPU. Which leaves are factored is decided
from their shapes and the configuration (`factored`); each group's split
into exact and factored leaves, and its kernels, are kept (`parts`).

Sharded parameters (DTensors of FSDP2 or the tensor axis,
`parallel/fsdp.py`) keep their moments as DTensors of the same placement;
the update runs on each rank's local shards, the muP table reads the
global shapes, and a factored leaf's sums of g² are summed over the ranks
that split it before its factors update. The kernels' tables of leaf
pointers are built at the first step (after FSDP2 has settled its sharded
storage) and again after `refresh()`, which a checkpoint load calls.
Under a profiler each `step` and `update_group` is a `vds/optim/update`
span (`utils/profiling.py`).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

from video_diffusion_speedrun_tpu_torch.core.config import OptimizerConfig
from video_diffusion_speedrun_tpu_torch.ops.fused_adamw import (
    FactoredAdamW,
    MultiTensorAdamW,
    adamw_leaf_update_plain,
    apply_direction,
    factor_moments,
    step_scalars,
)
from video_diffusion_speedrun_tpu_torch.parallel.collectives import (
    all_reduce_,
    local,
)
from video_diffusion_speedrun_tpu_torch.train.mup import mup_table
from video_diffusion_speedrun_tpu_torch.train.schedules import get_schedule
from video_diffusion_speedrun_tpu_torch.utils.profiling import span


def _zeros_like(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Zeros of p's shape in `dtype`; a DTensor's zeros are a DTensor of
    its placement, made from zeros of its local shard."""
    if not isinstance(p, DTensor):
        return torch.zeros_like(p, dtype=dtype)
    return DTensor.from_local(torch.zeros_like(p.to_local(), dtype=dtype),
                              p.device_mesh, p.placements, run_check=False,
                              shape=p.shape, stride=p.stride())


class FNu(NamedTuple):
    """The factored second moment of a torch [out, in] block weight (JAX's
    `FNu` of its [in, out] leaf): `vr` [in], the EMA of g²'s mean over
    out (JAX's row means), and `vc` [out], over in; fp32, this rank's
    shard of each. v̂ = vc ⊗ vr / mean(vr)."""

    vr: torch.Tensor
    vc: torch.Tensor


def group_of(name: str) -> str:
    """The update group of a parameter: its block, or "rest"."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "blocks" else "rest"


def factored_leaf_update(p: torch.Tensor, m: torch.Tensor, nu: FNu,
                         g: torch.Tensor, lr: float, wd: float, lr_t: float,
                         bc1: float, bc2: float, b1: float, b2: float,
                         eps: float, shape: Tuple[int, int],
                         sums=None) -> None:
    """JAX's factored branch of `_adamw_leaf` (`inloop.py:88-98`) on this
    rank's shard of a torch [out, in] weight of whole `shape`, in place.
    `sums(t, dim)` sums in place a partial sum over the ranks that split
    weight dim `dim` (None: no rank does)."""
    gf = g.float()
    m2 = b1 * m.float() + (1.0 - b1) * gf
    g2 = gf.square()
    # over out → [in], over in → [out]
    vr2, vc2, denom = factor_moments(nu.vr, nu.vc, g2.sum(0), g2.sum(1), b2,
                                     shape, sums)
    v2 = vc2[:, None] * vr2[None, :] / denom
    direction = (m2 / bc1) / ((v2 / bc2).sqrt() + eps)
    apply_direction(p, direction, lr, wd, lr_t)
    m.copy_(m2)
    nu.vr.copy_(vr2)
    nu.vc.copy_(vc2)


class MupAdamW:
    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 learning_rate: float, max_steps: int,
                 cfg: Optional[OptimizerConfig] = None, sharding=None):
        cfg = cfg or OptimizerConfig()
        named = list(named_params)
        self.cfg = cfg
        self.sharding = sharding  # parallel/fsdp.py: the factors' sums
        self.names = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        self.settings = mup_table(named, learning_rate, cfg.weight_decay, cfg)
        self.lrs = [self.settings[n]["lr"] for n in self.names]
        self.wds = [self.settings[n]["wd"] for n in self.names]
        self.schedule = get_schedule(cfg.scheduler, cfg.warmup_steps,
                                     max_steps)
        depth = len({group_of(n) for n in self.names} - {"rest"})
        self.factored = [
            cfg.in_backward and cfg.nu_factored and group_of(n) != "rest"
            and p.ndim == 2 and depth * p.numel() >= cfg.nu_factored_min_size
            for n, p in named]
        # the update groups of the in-backward step: name → leaf indices,
        # and the positions in each group of its exact and factored leaves
        self.groups: Dict[str, List[int]] = {}
        for i, n in enumerate(self.names):
            self.groups.setdefault(group_of(n), []).append(i)
        self.parts: Dict[str, Tuple[List[int], List[int]]] = {
            g: tuple([k for k, i in enumerate(idx) if self.factored[i] == f]
                     for f in (False, True))
            for g, idx in self.groups.items()}
        with torch.no_grad():
            self.m = [_zeros_like(p, cfg.moments_dtype or p.dtype)
                      for p in self.params]
            self.v = [
                FNu(*(torch.zeros(n, dtype=torch.float32, device=m.device)
                      for n in reversed(local(m).shape)))
                if fac else _zeros_like(m, m.dtype)
                for m, fac in zip(self.m, self.factored)]
        self.count = 0
        self._zero_grads = {}  # leaf index → zeros, for leaves with no grad
        self._kernel = None  # built at the next step on CUDA leaves
        # group → the kernel of its exact / factored leaves, built at first
        # use on CUDA leaves
        self._group_kernels = {}
        self._factored_kernels = {}
        # the train step's CUDA graphs over these leaves (train/step.py)
        self.step_graphs = None

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
        """Rebuild the kernel's leaf tables at the next step: call after
        anything that may have moved the parameters' or moments' storage
        (a checkpoint load); the train step's CUDA graphs, which hold the
        old storage's addresses, are dropped with them."""
        self._kernel = None
        self._group_kernels = {}
        self._factored_kernels = {}
        self.step_graphs = None

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
        with span("optim/update", self.params[0].device):
            grads = [self._grad(i, g) for i, g in enumerate(grads)]
            lr_t, bc1, bc2 = step_scalars(self.count, self.lr_scale(),
                                          cfg.beta1, cfg.beta2)
            params, ms, vs = self.leaves()
            if self._kernel is None:
                kernel = self.kernel_for(params)
                if kernel is not None:
                    self._kernel = kernel(params, ms, vs, self.lrs,
                                          self.wds, cfg.beta1, cfg.beta2,
                                          cfg.eps)
            if self._kernel is not None:
                self._kernel(grads, lr_t, bc1, bc2)
            else:
                for p, m, v, g, lr, wd in zip(params, ms, vs, grads,
                                              self.lrs, self.wds):
                    adamw_leaf_update_plain(p, m, v, g, lr, wd, lr_t, bc1,
                                            bc2, cfg.beta1, cfg.beta2,
                                            cfg.eps)
            self.count += 1

    @torch.no_grad()
    def update_group(self, group: str,
                     grads: Sequence[Optional[torch.Tensor]]) -> None:
        """Update the leaves of `group` (`self.groups[group]`, in order)
        from their local `grads` (None: zero) at the current count; on CUDA
        the exact leaves in one launch, the factored ones in two. The count
        stays: `advance` after the step's last group."""
        cfg = self.cfg
        idx = self.groups[group]
        if len(grads) != len(idx):
            raise ValueError(f"{len(grads)} grads for group {group} of "
                             f"{len(idx)} leaves")
        with span("optim/update", self.params[0].device):
            grads = [self._grad(i, g) for i, g in zip(idx, grads)]
            lr_t, bc1, bc2 = step_scalars(self.count, self.lr_scale(),
                                          cfg.beta1, cfg.beta2)
            exact, factored = self.parts[group]
            kernel, fkernel = self._kernels_of(group)
            if kernel is not None:
                kernel([grads[k] for k in exact], lr_t, bc1, bc2)
            if fkernel is not None:
                fkernel([grads[k] for k in factored], lr_t, bc1, bc2)
            plain = ((exact if kernel is None else [])
                     + (factored if fkernel is None else []))
            for k in plain:  # CPU leaves: the twins
                i = idx[k]
                args = (local(self.params[i]).detach(), local(self.m[i]),
                        self.v[i] if self.factored[i] else local(self.v[i]),
                        grads[k], self.lrs[i], self.wds[i], lr_t, bc1, bc2,
                        cfg.beta1, cfg.beta2, cfg.eps)
                if self.factored[i]:
                    factored_leaf_update(*args, tuple(self.params[i].shape),
                                         self._factor_sums(self.names[i]))
                else:
                    adamw_leaf_update_plain(*args)

    def _kernels_of(self, group: str):
        """The kernels of `group`'s exact and factored leaves over their
        local shards (None: none of that kind, or CPU leaves), each built at
        its first use."""
        cfg = self.cfg
        idx = self.groups[group]
        exact, factored = ([idx[k] for k in ks] for ks in self.parts[group])
        kernel = self._group_kernels.get(group)
        if kernel is None and exact:
            params = [local(self.params[i]).detach() for i in exact]
            make = self.kernel_for(params)
            if make is not None:
                kernel = self._group_kernels[group] = make(
                    params, [local(self.m[i]) for i in exact],
                    [local(self.v[i]) for i in exact],
                    [self.lrs[i] for i in exact],
                    [self.wds[i] for i in exact], cfg.beta1, cfg.beta2,
                    cfg.eps)
        fkernel = self._factored_kernels.get(group)
        if fkernel is None and factored:
            params = [local(self.params[i]).detach() for i in factored]
            if params[0].is_cuda:  # CPU leaves: `factored_leaf_update`
                fkernel = self._factored_kernels[group] = FactoredAdamW(
                    params, [local(self.m[i]) for i in factored],
                    [self.v[i].vr for i in factored],
                    [self.v[i].vc for i in factored],
                    [tuple(self.params[i].shape) for i in factored],
                    [self.lrs[i] for i in factored],
                    [self.wds[i] for i in factored], cfg.beta1, cfg.beta2,
                    cfg.eps,
                    [self._factor_sums(self.names[i]) for i in factored])
        return kernel, fkernel

    def advance(self) -> None:
        """End the step of `update_group` calls: the count moves on."""
        self.count += 1

    def _factor_sums(self, name: str):
        """The `sums` of `factored_leaf_update` for leaf `name`: over the
        fsdp and tensor groups that split each weight dim."""
        sh = self.sharding
        if sh is None:
            return None
        pl = sh.placements[name]
        split = {}
        if sh.fsdp_group is not None and pl.fsdp is not None:
            split.setdefault(pl.fsdp, []).append(sh.fsdp_group)
        if sh.region is not None and pl.tensor is not None:
            split.setdefault(pl.tensor, []).append(sh.tensor_group)
        if not split:
            return None

        def sums(t: torch.Tensor, dim: int) -> None:
            for group in split.get(dim, ()):
                all_reduce_([t], group)

        return sums
