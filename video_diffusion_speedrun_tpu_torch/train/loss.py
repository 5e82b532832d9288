"""Rectified-flow training loss (port of `train/loss.py`).

- caption dropout: each sample's context zeroed with probability 0.01;
- logit-normal timesteps t = sigmoid(N(0, 1)), then the time shift
  t ← tα/(1+(α−1)t) with α = 8;
- interpolant z_t = x·(1−t) + noise·t and velocity target x − noise, in
  the compute dtype;
- per-sample MSE over (C, T, H, W) in fp32, then the batch mean;
- per-decile loss sums and counts of t.

Randomness comes from one `torch.Generator`, drawn in the JAX order
(timesteps, noise, dropout, rope offsets); `timesteps`, `noise` and
`rope_offsets` may be injected for parity tests, as in JAX. Under context
parallelism (`context_parallel`, a ring) every rank of the ring draws the
same numbers from a generator seeded alike and computes the same loss
from the gathered model output.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.models.rope import random_rope_offsets


def time_shift(t, alpha: float):
    """t ← tα/(1+(α−1)t): shifts the sampling density toward noise."""
    return t * alpha / (1 + (alpha - 1) * t)


def sample_timesteps(generator: torch.Generator, b: int,
                     alpha: float) -> torch.Tensor:
    """Logit-normal t with the time shift, fp32 [b] on the generator's
    device."""
    z = torch.randn(b, generator=generator, device=generator.device)
    return time_shift(torch.sigmoid(z), alpha)


class FlowInputs(NamedTuple):
    """The model's inputs and target of one batch: z_t, the velocity
    target, the (dropped-out) context, the timesteps and rope offsets."""

    z_t: torch.Tensor
    v_objective: torch.Tensor
    context: Optional[torch.Tensor]
    timesteps: torch.Tensor
    rope_offsets: Optional[torch.Tensor]


def flow_inputs(
    cfg,
    latent: torch.Tensor,
    context: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    *,
    alpha: float = 8.0,
    caption_dropout: float = 0.01,
    timesteps: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    rope_offsets: Optional[torch.Tensor] = None,
) -> FlowInputs:
    """The draws and the interpolant of the loss (`cfg` a `DiTConfig`), in
    the JAX order; what is injected is not drawn."""
    cdt = cfg.compute_dtype
    b = latent.shape[0]
    dev = latent.device
    # floor-crop to patch multiples (Cosmos latents have 1+4k frames; the
    # strided patchify drops the remainder, so the target must too)
    _, _, t_len, h_len, w_len = latent.shape
    pt, p = cfg.time_patch_size, cfg.patch_size
    latent = latent[:, :, : t_len // pt * pt, : h_len // p * p,
                    : w_len // p * p].to(cdt)

    if timesteps is None:
        timesteps = sample_timesteps(generator, b, alpha)
    if noise is None:
        noise = torch.randn(latent.shape, generator=generator, device=dev,
                            dtype=cdt)
    noise = noise.to(cdt)

    if context is not None:
        context = context.to(cdt)
        if caption_dropout > 0:
            drop = torch.rand(b, generator=generator, device=dev) \
                < caption_dropout
            context = torch.where(drop[:, None, None],
                                  torch.zeros((), dtype=cdt, device=dev),
                                  context)

    if rope_offsets is None and cfg.use_rope:
        rope_offsets = random_rope_offsets(
            generator, latent.shape[2] // pt, latent.shape[3] // p,
            latent.shape[4] // p, cfg.rope_max_t, cfg.rope_max_h,
            cfg.rope_max_w)

    tr = timesteps.to(cdt).reshape(b, 1, 1, 1, 1)
    z_t = latent * (1 - tr) + noise * tr
    return FlowInputs(z_t, latent - noise, context, timesteps, rope_offsets)


def flow_loss(out: torch.Tensor, v_objective: torch.Tensor,
              timesteps: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, aux) of the model output against the velocity target."""
    err = v_objective.float() - out.float()
    loss_per_sample = err.square().mean(dim=(1, 2, 3, 4))
    loss = loss_per_sample.mean()

    tbin = (timesteps * 10).to(torch.int64).clamp(0, 9)
    zeros = torch.zeros(10, dtype=torch.float32, device=out.device)
    lps = loss_per_sample.detach()
    aux = {
        "loss_per_sample": lps,
        "timesteps": timesteps,
        "bin_sums": zeros.scatter_add(0, tbin, lps),
        "bin_counts": zeros.scatter_add(0, tbin, torch.ones_like(lps)),
    }
    return loss, aux


def rectified_flow_loss(
    model: DiT,
    latent: torch.Tensor,
    context: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    *,
    alpha: float = 8.0,
    caption_dropout: float = 0.01,
    timesteps: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    rope_offsets: Optional[torch.Tensor] = None,
    context_parallel=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (loss, aux) with aux `loss_per_sample`, `timesteps`,
    `bin_sums` and `bin_counts` ([10] fp32). `generator` may be None when
    every random input is injected and caption dropout is 0."""
    inp = flow_inputs(model.cfg, latent, context, generator, alpha=alpha,
                      caption_dropout=caption_dropout, timesteps=timesteps,
                      noise=noise, rope_offsets=rope_offsets)
    out = model(inp.z_t, inp.context, inp.timesteps,
                rope_offsets=inp.rope_offsets,
                context_parallel=context_parallel)
    return flow_loss(out, inp.v_objective, inp.timesteps)
