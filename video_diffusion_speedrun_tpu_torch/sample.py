"""Sampling entry point of the port: Euler+CFG sampling of the demo DiT with
random weights (the `--random_weights` smoke path of the JAX `sample.py`).

    python -m video_diffusion_speedrun_tpu_torch.sample --inference_steps 8

samples at the default 512×512 with 16 latent frames (L = 8208 tokens, the
long attention path); `--height 256 --width 256 --num_latent_frames 8`
gives L = 1040, the short path. Runs on the card by default (`--device
cuda`, which raises when no card is present); `--device cpu` runs on the
CPU. Prints the shape and std of the sampled latents. Prompt encoding (T5)
and the Cosmos decode come with later slices, so the context is seeded
random noise.

Context parallelism splits the tokens of one video over N cards (a ring
over `torch.distributed`; JAX's `--mesh_context`):

    torchrun --nproc_per_node 4 -m video_diffusion_speedrun_tpu_torch.sample \
        --mesh_context 4

Each process runs on the card `LOCAL_RANK` and all of them sample the same
request; rank 0 prints. `--mesh_context` must equal the number of
processes (`WORLD_SIZE`): N > 1 without a launcher raises.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from video_diffusion_speedrun_tpu_torch.core.config import (
    DiTConfig,
    MeshConfig,
    SamplingConfig,
    resolve_device,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh
from video_diffusion_speedrun_tpu_torch.parallel.ring import DistRing
from video_diffusion_speedrun_tpu_torch.sampling.euler import generate_latents


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--inference_steps", type=int, default=50)
    p.add_argument("--cfg_scale", type=float, default=6.0)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num_latent_frames", type=int, default=16)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--model_width", type=int, default=2048)
    p.add_argument("--model_depth", type=int, default=24)
    p.add_argument("--model_head_dim", type=int, default=128)
    p.add_argument("--rope_order", choices=["matched", "reference"],
                   default="matched")
    p.add_argument("--context_dim", type=int, default=4096)
    p.add_argument("--device", default="cuda")
    p.add_argument("--mesh_context", type=int, default=1,
                   help="cards the tokens of one video are split over "
                        "(one process each, under torchrun)")
    return p.parse_args(argv)


def demo_config(model_width: int, model_depth: int, model_head_dim: int,
                context_dim: int, rope_order: str = "matched",
                **overrides) -> DiTConfig:
    """The demo-model architecture of the JAX `sample.py`."""
    return DiTConfig(
        in_channels=16, patch_size=2, time_patch_size=2,
        hidden_size=model_width, depth=model_depth,
        num_heads=model_width // model_head_dim, mlp_ratio=4.0,
        cross_attn_input_size=context_dim, residual_v=True,
        train_bias_and_rms=False, rope_order=rope_order, **overrides)


def main(argv: Optional[List[str]] = None) -> torch.Tensor:
    args = parse_args(argv)
    device = pmesh.init_distributed(resolve_device(args.device))
    mesh = pmesh.build_mesh(MeshConfig(fsdp=1, context=args.mesh_context),
                            device.type)
    group = pmesh.context_group(mesh)
    ring = None if group is None else DistRing(group)
    say = print if pmesh.global_rank() == 0 else (lambda *a, **k: None)
    model_cfg = demo_config(args.model_width, args.model_depth,
                            args.model_head_dim, args.context_dim,
                            args.rope_order)
    sampling = SamplingConfig(
        inference_steps=args.inference_steps, cfg_scale=args.cfg_scale,
        height=args.height, width=args.width,
        num_latent_frames=args.num_latent_frames, seed=args.seed)

    say("using RANDOM weights (smoke mode)")
    model = DiT(model_cfg, device=device, init_std_factor=0.1, seed=0)
    gen = torch.Generator(device=device).manual_seed(1)
    context = torch.randn(1, 512, args.context_dim, generator=gen,
                          device=device).to(torch.bfloat16) * 0.05

    say(f"sampling {args.inference_steps} steps, cfg {args.cfg_scale}"
        f"{f', tokens split over {ring.size} ranks' if ring else ''} ...")
    t0 = time.perf_counter()
    latents = generate_latents(model, context, sampling,
                               context_parallel=ring)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    say(f"latents {tuple(latents.shape)}, std {float(latents.std()):.3f} "
        f"({time.perf_counter() - t0:.2f} s on {device})")
    pmesh.shutdown()
    return latents


if __name__ == "__main__":
    main()
