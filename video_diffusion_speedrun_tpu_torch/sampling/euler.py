"""Euler + CFG rectified-flow sampler (port of `sampling/euler.py`).

Timesteps i = N…1 with the α shift on both t and t_next; guidance
`uncond + s·(cond − uncond)` in fp32 with a zero-context uncond branch;
cond and uncond run as one forward at batch 2B (cond first); the
accumulator is fp32 and each step's model input is `acc` cast to the
latents' dtype. The context K/V is projected once per trajectory.

RoPE crop jitter (`euler.py:60-112` of the JAX sampler) is off by default
(zero offsets, deterministic sampling); given a `jitter` generator, each
Euler step draws one `random_rope_offsets` from it and its single batched
CFG forward uses it for cond and uncond alike.

Under context parallelism (`context_parallel`, a ring of
`parallel/ring.py`; JAX's `token_sharding`, `euler.py:63-113`) every rank
of the ring runs the same trajectory on the same noise and context: each
forward splits the tokens over the ring and gathers the output, so every
rank holds the whole latents after every step.

`euler_guidance_sample` is HunyuanVideo's guidance-distilled sampler
(`models/hunyuan_video.py`; Tencent's `FlowMatchDiscreteScheduler` with
the Euler solver): the same `schedule` with α the flow shift, one forward
a step at batch 1 with the guidance scale as an embedding, the model's
timestep 1000·σ, and the step x ← x + (σ_next − σ)·v into an fp32
accumulator. Each step is a `vds/sample/step` span.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from video_diffusion_speedrun_tpu_torch.core.config import SamplingConfig
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.models.rope import random_rope_offsets
from video_diffusion_speedrun_tpu_torch.train.loss import time_shift
from video_diffusion_speedrun_tpu_torch.utils.profiling import span


def initial_latents(generator: torch.Generator, cfg: SamplingConfig,
                    channels: int = 16,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[1, C, frames, 2·(H//16), 2·(W//16)] gaussian noise from `generator`,
    on the generator's device."""
    shape = (1, channels, cfg.num_latent_frames, 2 * (cfg.height // 16),
             2 * (cfg.width // 16))
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32).to(dtype)


def schedule(num_steps: int, alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t_i, dt_i) fp32 for i = N…1, α-shifted."""
    i = torch.arange(num_steps, 0, -1, dtype=torch.float32)
    t = time_shift(i / num_steps, alpha)
    t_next = time_shift((i - 1) / num_steps, alpha)
    return t, t - t_next


@torch.no_grad()
def euler_cfg_sample(model: DiT, latents: torch.Tensor,
                     context: torch.Tensor, *, num_steps: int = 50,
                     cfg_scale: float = 6.0,
                     alpha: float = 8.0,
                     context_parallel=None,
                     jitter: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Run the Euler trajectory; returns the fp32 accumulator.

    `latents` [B, C, T, h, w], `context` [B, Lc, ctx_dim] (the conditional
    embedding; the uncond branch is zeros), both on the model's device.
    `jitter`: the generator of each step's RoPE crop offsets (None: no
    jitter)."""
    ts, dts = schedule(num_steps, alpha)
    acc = latents.float()
    do_cfg = cfg_scale > 1.0
    ckv = None
    if model.cfg.cross_attn_input_size is not None:
        ctx = torch.cat([context, torch.zeros_like(context)]) if do_cfg \
            else context
        ckv = model.precompute_context_kv(ctx)
    b = acc.shape[0]
    mcfg = model.cfg
    grid = (latents.shape[2] // mcfg.time_patch_size,
            latents.shape[3] // mcfg.patch_size,
            latents.shape[4] // mcfg.patch_size)
    for t, dt in zip(ts.tolist(), dts.tolist()):
        lat = acc.to(latents.dtype)
        tvec = torch.full((b,), t, dtype=torch.float32, device=acc.device)
        offsets = None
        if jitter is not None:
            offsets = random_rope_offsets(jitter, *grid, mcfg.rope_max_t,
                                          mcfg.rope_max_h, mcfg.rope_max_w)
        if do_cfg:
            out2 = model(torch.cat([lat, lat]), None, torch.cat([tvec, tvec]),
                         rope_offsets=offsets, context_kv=ckv,
                         context_parallel=context_parallel)
            cond, uncond = out2.float().chunk(2)
            out = uncond + cfg_scale * (cond - uncond)
        else:
            out = model(lat, None, tvec, rope_offsets=offsets, context_kv=ckv,
                        context_parallel=context_parallel).float()
        acc = acc + dt * out
    return acc


def generate_latents(model: DiT, context: torch.Tensor,
                     sampling: SamplingConfig,
                     generator: Optional[torch.Generator] = None,
                     context_parallel=None,
                     jitter: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Seeded initial noise → sampled fp32 latents. The noise comes from
    `generator`, by default one on the model's device seeded with
    `sampling.seed` (the same noise on every rank of a context ring);
    `jitter` as in `euler_cfg_sample`."""
    if generator is None:
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(sampling.seed)
    latents = initial_latents(generator, sampling,
                              channels=model.cfg.in_channels)
    return euler_cfg_sample(model, latents, context,
                            num_steps=sampling.inference_steps,
                            cfg_scale=sampling.cfg_scale,
                            alpha=sampling.time_shift_alpha,
                            context_parallel=context_parallel, jitter=jitter)


@torch.no_grad()
def euler_guidance_sample(model, latents: torch.Tensor,
                          text_states: torch.Tensor,
                          text_states_2: torch.Tensor, *,
                          text_mask: Optional[torch.Tensor] = None,
                          num_steps: int = 50, guidance: float = 6.0,
                          shift: float = 7.0) -> torch.Tensor:
    """HunyuanVideo's Euler trajectory from `latents` [1, C, T, H, W]; returns
    the fp32 accumulator. text_states [1, Lt, 4096] with text_mask [1, Lt]
    (None: all valid), text_states_2 [1, 768]: the request's conditioning
    runs once (`model.condition`), then `num_steps` forwards with the
    embedded guidance `guidance`·1000."""
    dev = latents.device
    ts, dts = schedule(num_steps, shift)
    cond = model.condition(text_states, text_states_2,
                           torch.full((1,), guidance * 1000.0, device=dev),
                           text_mask)
    acc = latents.float()
    for t, dt in zip(ts.tolist(), dts.tolist()):
        with span("sample/step", dev):
            v = model(acc.to(latents.dtype),
                      torch.full((1,), 1000.0 * t, device=dev), cond)
            acc = acc.add(v, alpha=-dt)  # x + (σ_next − σ)·v
    return acc
