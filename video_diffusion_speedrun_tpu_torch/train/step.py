"""Train and eval steps (port of `train/step.py`).

`train_step` runs the loss forward, its backward (remat recomputes each
block) and one muP-AdamW update, and returns the step's metrics as device
tensors, so the caller decides when to read them back. With
`grad_accum > 1` the batch splits into equal microbatches whose gradients
and losses are averaged and whose bins are summed (`accumulate_grads`,
`step.py:42-74`). A batch may inject `timesteps`, `noise` (split with the
batch) and `rope_offsets` (shared); a batch with no `context` gets
0.05·N(0, 1) [b, caption_tokens, context_dim] drawn on the device in the
compute dtype (`step.py:132-141`). Under a profiler the step is a
`vds/step` span holding each microbatch's `vds/step/forward` and
`vds/step/backward` (`utils/profiling.py:span`); the reductions after them
are the step's own time.

Across processes (`parallel/mesh.py`) the step reduces what GSPMD reduces
in JAX. FSDP2 (`parallel/fsdp.py`) reduce-scatters the sharded parameters'
gradients inside `backward`, averaged over the data shards (replica ×
fsdp). Then, on each rank's local shards: every gradient is summed over
the context ring's group (each rank's backward holds its own tokens'
share); the gradients of replicated leaves used inside the tensor region
(λ, the column-parallel biases) are summed over the tensor group; the
leaves FSDP2 does not hold are averaged over the data group. grad_norm is
the norm of the global gradient: each shard counted once, a replicated
leaf once. The loss is averaged and the decile bins summed over the data
group. `LocalRing` (all ranks in one process) needs no reduction.

`step_for(cfg)` picks the step of the config, as JAX's `build_train_step`
branches on `optimizer.in_backward` (`step.py:218-317`): `train_step`,
or the optimizer-in-backward step of `train/inloop.py`, which refuses the
context axis and `log_grad_norm` as JAX's branch does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from video_diffusion_speedrun_tpu_torch.core.config import TrainConfig
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.parallel.collectives import (
    all_reduce_,
    local,
)
from video_diffusion_speedrun_tpu_torch.train.loss import rectified_flow_loss
from video_diffusion_speedrun_tpu_torch.train.optim import MupAdamW
from video_diffusion_speedrun_tpu_torch.utils.profiling import span

_SPLIT = ("latent", "context", "timesteps", "noise")


def _loss(model: DiT, batch: Dict, generator: Optional[torch.Generator],
          cfg: TrainConfig, context_parallel):
    mcfg = model.cfg
    latent = batch["latent"]
    context = batch.get("context")
    if context is None and mcfg.cross_attn_input_size is not None:
        context = 0.05 * torch.randn(
            latent.shape[0], cfg.data.caption_tokens, cfg.data.context_dim,
            generator=generator, device=latent.device,
            dtype=mcfg.compute_dtype)
    return rectified_flow_loss(
        model, latent, context, generator, alpha=cfg.time_shift_alpha,
        caption_dropout=cfg.caption_dropout,
        timesteps=batch.get("timesteps"), noise=batch.get("noise"),
        rope_offsets=batch.get("rope_offsets"),
        context_parallel=context_parallel)


def _microbatches(batch: Dict, n: int):
    if n <= 1:
        return [batch]
    b = batch["latent"].shape[0]
    micro = b // n
    return [{k: (v[i * micro:(i + 1) * micro] if k in _SPLIT else v)
             for k, v in batch.items()} for i in range(n)]


def train_step(model: DiT, opt: MupAdamW, batch: Dict,
               generator: Optional[torch.Generator], cfg: TrainConfig,
               context_parallel=None, data_group=None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step on this replica's `batch`. Returns {loss,
    lr_scale, bin_sums, bin_counts, timesteps [, grad_norm]}; lr_scale is
    λ of this update (the count before it), timesteps this replica's
    draws [b]. `context_parallel`: the ring that splits
    the tokens; `data_group`: the process group of the replicas (None:
    one)."""
    dev = batch["latent"].device
    with span("step", dev):
        accum = cfg.grad_accum
        loss_sum = 0.0
        bin_sums = bin_counts = 0.0
        timesteps = []
        for mb in _microbatches(batch, accum):
            with span("step/forward", dev):
                loss, aux = _loss(model, mb, generator, cfg,
                                  context_parallel)
            with span("step/backward", dev):
                loss.backward()
            loss_sum = loss_sum + loss.detach()
            bin_sums = bin_sums + aux["bin_sums"]
            bin_counts = bin_counts + aux["bin_counts"]
            timesteps.append(aux["timesteps"])
        grads = [p.grad for p in opt.params]
        if accum > 1:
            for g in grads:
                if g is not None:
                    local(g).mul_(1.0 / accum)
        sharding = getattr(model, "sharding", None)
        all_reduce_(grads, getattr(context_parallel, "group", None))
        if sharding is None:
            all_reduce_(grads, data_group, mean=True)
        else:
            all_reduce_([g for n, g in zip(opt.names, grads)
                         if n in sharding.tensor_partial],
                        sharding.tensor_group)
            all_reduce_([g for n, g in zip(opt.names, grads)
                         if n not in sharding.fsdp_managed], data_group,
                        mean=True)
        loss = loss_sum / accum if accum > 1 else loss_sum
        all_reduce_([loss], data_group, mean=True)
        all_reduce_([bin_sums, bin_counts], data_group)
        metrics = {"loss": loss, "lr_scale": opt.lr_scale(),
                   "bin_sums": bin_sums, "bin_counts": bin_counts,
                   "timesteps": torch.cat(timesteps)}
        if cfg.log_grad_norm:
            metrics["grad_norm"] = grad_norm(opt.names, grads, sharding)
        opt.step(grads)
        for p in opt.params:
            p.grad = None
        return metrics


def step_for(cfg: TrainConfig):
    """The train step of `cfg`: `train_step`, or with
    `optimizer.in_backward` `inloop_step` (same arguments and metrics),
    after JAX's refusals: the context axis (no token-sharded path in the
    hand-rolled forward) and `log_grad_norm` (the whole gradient never
    exists)."""
    if not cfg.optimizer.in_backward:
        return train_step
    if cfg.mesh.context > 1:
        raise NotImplementedError(
            "optimizer_in_backward does not support the context "
            "(sequence-parallel) mesh axis: its hand-rolled forward has no "
            "token-sharded path — use the standard step for CP runs")
    if cfg.log_grad_norm:
        raise ValueError(
            "log_grad_norm is unavailable with optimizer_in_backward: the "
            "full gradient never materializes (that is the point)")
    from video_diffusion_speedrun_tpu_torch.train.inloop import inloop_step

    return inloop_step


def grad_norm(names, grads, sharding=None) -> torch.Tensor:
    """The L2 norm of the global gradient from each rank's reduced local
    shards: the squares summed per kind of placement, each sum then over
    the axes that kind is sharded on (fsdp, tensor), so every element
    counts once. None gradients count 0."""
    sums = {}
    for name, g in zip(names, grads):
        if g is None:
            continue
        key = (False, False)
        if sharding is not None:
            key = (name in sharding.fsdp_managed,
                   sharding.placements[name].tensor is not None
                   and sharding.region is not None)
        sq = local(g).float().square().sum()
        sums[key] = sq if key not in sums else sums[key] + sq
    total = 0.0
    for (fsdp, tensor), sq in sums.items():
        all_reduce_([sq], sharding.fsdp_group if fsdp else None)
        all_reduce_([sq], sharding.tensor_group if tensor else None)
        total = total + sq
    return torch.sqrt(total)


@torch.no_grad()
def eval_step(model: DiT, batch: Dict, generator: torch.Generator,
              cfg: TrainConfig, context_parallel=None
              ) -> Dict[str, torch.Tensor]:
    """The loss on one batch without gradients: {loss, bin_sums,
    bin_counts}."""
    loss, aux = _loss(model, batch, generator, cfg, context_parallel)
    return {"loss": loss, "bin_sums": aux["bin_sums"],
            "bin_counts": aux["bin_counts"]}
