"""Sampling entry point of the port: the text-to-video request — checkpoint
→ T5 prompt encoding → Euler+CFG sampling of the demo DiT → Cosmos decode
→ video file (the JAX `sample.py`).

    python -m video_diffusion_speedrun_tpu_torch.sample \\
        --prompt "a mountain range in fog" --checkpoint ckpts/run1 \\
        --decoder_weights decoder.npz --inference_steps 50 --seed 42

samples at the default 512×512 with 16 latent frames (L = 8208 tokens, the
long attention path) and writes 61 frames of 512×512 to
`--output/--name.mp4`, or `--output/--name/video.npy` (+ PNG frames where
imageio can write them) when no h264 encoder is installed.
`--checkpoint` takes a port checkpoint (a run root or a step directory of
the train CLI), a torch reference DCP directory or a `.pt`; with
`--rope_order auto` a reference checkpoint samples with the reference's
(t, h, w) RoPE order. The prompt is encoded by the local FLUX.1-dev T5
(`--return_index`, default -1). Without `--checkpoint` (or with
`--random_weights`) the DiT has random weights and the context is seeded
noise, unless `--smoke_encoder` (a tiny random T5) or `--smoke_encoder
xxl` (T5-XXL with random weights), both with the byte-fallback tokenizer,
encode the prompt. Without `--decoder_weights` (the `.npz` of
`scripts/convert_cosmos.py`) the decoder has random weights and the video
is noise. Runs on the card by default (`--device cuda`, which raises when
no card is present); `--device cpu` runs on the CPU.

Context parallelism splits the tokens of one video over N cards (a ring
over `torch.distributed`; JAX's `--mesh_context`):

    torchrun --nproc_per_node 4 -m video_diffusion_speedrun_tpu_torch.sample \\
        --mesh_context 4 --prompt "..."

Each process runs on the card `LOCAL_RANK` and all of them sample the same
request; rank 0 alone prints, decodes and writes. `--mesh_context` must
equal the number of processes (`WORLD_SIZE`): N > 1 without a launcher
raises. `--steps_per_call`, with which JAX splits the trajectory into
programs, is accepted and changes nothing.

`--model hunyuanvideo` samples HunyuanVideo (`HYVideo-T/2-cfgdistill`,
`models/hunyuan_video.py`) with its guidance-distilled Euler sampler
(`euler_guidance_sample`: batch 1, `--guidance` embedded, `--flow_shift`)
on one card, and writes the fp32 latents to `--output/--name_latents.pt`:

    python -m video_diffusion_speedrun_tpu_torch.sample --model hunyuanvideo \
        --height 544 --width 960 --num_latent_frames 9 --random_weights

Its text comes from `--text_states`, a `.pt` dict of `text_states`
[Lt, 4096], `text_mask` [Lt] (optional) and `text_states_2` [768] (the
LLM's and CLIP's outputs); with `--random_weights` and no file the text is
seeded noise (256 slots, all valid). `--checkpoint` takes a published
checkpoint file (its state dict loads with `strict=True`); without one the
weights are random. Its LLM and CLIP encoders and its VAE are not in the
repository, so no prompt is encoded and no video decoded.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import torch

from video_diffusion_speedrun_tpu_torch.core import config
from video_diffusion_speedrun_tpu_torch.core.config import (
    DiTConfig,
    MeshConfig,
    SamplingConfig,
    resolve_device,
)
from video_diffusion_speedrun_tpu_torch.models.cosmos_vae import (
    CosmosDecoder,
    CosmosDecoderConfig,
    decode_video,
    load_decoder_params,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.models.hunyuan_video import (
    HunyuanVideo,
    load_published,
)
from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh
from video_diffusion_speedrun_tpu_torch.parallel.ring import DistRing
from video_diffusion_speedrun_tpu_torch.sampling.decode import save_video
from video_diffusion_speedrun_tpu_torch.sampling.euler import (
    euler_guidance_sample,
    generate_latents,
    initial_latents,
)
from video_diffusion_speedrun_tpu_torch.train.checkpoint import (
    is_port_checkpoint,
    is_torch_reference_checkpoint,
    load_reference_checkpoint,
    restore_params_for_inference,
)

# latent frames per decoded chunk (`save_latents_to_video`'s default)
DECODE_CHUNK = 4


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=["dit", "hunyuanvideo"],
                   default="dit",
                   help="the speedrun's demo DiT, or HunyuanVideo")
    p.add_argument("--text_states", default=None,
                   help="hunyuanvideo: a .pt dict of text_states [Lt, 4096], "
                        "text_mask [Lt] and text_states_2 [768]")
    p.add_argument("--guidance", type=float, default=6.0,
                   help="hunyuanvideo: the embedded guidance scale")
    p.add_argument("--flow_shift", type=float, default=7.0,
                   help="hunyuanvideo: the schedule's shift")
    p.add_argument("--prompt", default=None,
                   help="the text to encode (needed whenever a T5 encodes)")
    p.add_argument("--checkpoint", default=None,
                   help="port checkpoint (run root or step dir), torch "
                        "reference DCP dir, or .pt")
    p.add_argument("--inference_steps", type=int, default=50)
    p.add_argument("--cfg_scale", type=float, default=6.0)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num_latent_frames", type=int, default=16)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--model_width", type=int, default=2048)
    p.add_argument("--model_depth", type=int, default=24)
    p.add_argument("--model_head_dim", type=int, default=128)
    p.add_argument("--return_index", type=int, default=-1,
                   help="T5 hidden-state index (sampling default -1)")
    p.add_argument("--rope_order", choices=["auto", "matched", "reference"],
                   default="auto",
                   help="RoPE table token order; 'auto' = 'reference' for "
                        "torch reference checkpoints, else 'matched'")
    p.add_argument("--decoder_weights", default=None,
                   help="converted Cosmos decoder .npz "
                        "(scripts/convert_cosmos.py); without it the decoder "
                        "runs with RANDOM weights")
    p.add_argument("--output", default="./output")
    p.add_argument("--name", default="test")
    p.add_argument("--random_weights", action="store_true",
                   help="skip the checkpoint (random DiT weights)")
    p.add_argument("--context_dim", type=int, default=4096,
                   help="cross-attention context width (4096 = T5-XXL)")
    p.add_argument("--smoke_encoder", nargs="?", const="tiny",
                   choices=["tiny", "xxl"], default=None,
                   help="encode the prompt with a RANDOM-INIT T5 (tiny, or "
                        "the XXL config) and the byte-fallback tokenizer; "
                        "embeddings are garbage")
    p.add_argument("--device", default="cuda")
    p.add_argument("--mesh_context", type=int, default=1,
                   help="cards the tokens of one video are split over "
                        "(one process each, under torchrun)")
    # JAX splits one jitted trajectory into programs of this many steps (a
    # TPU watchdog); the port runs step by step: accepted, no effect
    p.add_argument("--steps_per_call", type=int, default=None,
                   help="accepted for the JAX command line; no effect")
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


def load_dit(checkpoint: Optional[str], model_cfg: DiTConfig,
             device) -> DiT:
    """The DiT with the weights of `checkpoint` (a port checkpoint, or the
    reference's), checked against `model_cfg`; random weights (init std
    factor 0.1, seed 0) without one."""
    model = DiT(model_cfg, device=device, init_std_factor=0.1, seed=0)
    if checkpoint is not None:
        if is_port_checkpoint(checkpoint):
            state = restore_params_for_inference(checkpoint, model_cfg)
        else:
            state = load_reference_checkpoint(checkpoint, model_cfg)
        model.load_state_dict(state)
    return model


def load_decoder(decoder_weights: Optional[str], device,
                 say=print) -> CosmosDecoder:
    """The default-config Cosmos decoder: converted weights, or random ones
    (seed 2) with a loud warning."""
    cfg = CosmosDecoderConfig()
    decoder = CosmosDecoder(cfg, device=device, seed=2)
    if decoder_weights is not None:
        decoder.load_state_dict(load_decoder_params(decoder_weights, cfg))
        say(f"loaded Cosmos decoder weights from {decoder_weights}")
    else:
        say("WARNING: no --decoder_weights given — decoding with RANDOM "
            "Cosmos decoder weights; the output video will be noise. Convert "
            "the pretrained decoder with scripts/convert_cosmos.py first.")
    return decoder


def sample_hunyuan(args: argparse.Namespace, device: torch.device,
                   report: Dict) -> torch.Tensor:
    """One HunyuanVideo request on one card: the latents, written to
    `--output/--name_latents.pt`."""
    if args.mesh_context != 1:
        raise ValueError("--model hunyuanvideo samples on one card")
    cfg = config.HunyuanVideoConfig()
    model = HunyuanVideo(cfg, device=device, seed=0)
    if args.checkpoint and not args.random_weights:
        model.load_state_dict(load_published(args.checkpoint), strict=True)
    else:
        print("using RANDOM weights (smoke mode)")
    if args.text_states is not None:
        d = torch.load(args.text_states, map_location=device,
                       weights_only=True)
        text = d["text_states"].reshape(1, -1, cfg.text_states_dim)
        mask = d.get("text_mask")
        mask = None if mask is None else mask.reshape(1, -1).bool()
        text_2 = d["text_states_2"].reshape(1, cfg.text_states_dim_2)
    elif args.random_weights:
        gen = torch.Generator(device=device).manual_seed(1)
        text = torch.randn(1, cfg.text_len, cfg.text_states_dim,
                           generator=gen, device=device)
        text_2 = torch.randn(1, cfg.text_states_dim_2, generator=gen,
                             device=device)
        mask = None
    else:
        raise ValueError("--model hunyuanvideo needs --text_states (its "
                         "text encoders are not in the repository), or "
                         "--random_weights for seeded noise")
    sampling = SamplingConfig(height=args.height, width=args.width,
                              num_latent_frames=args.num_latent_frames,
                              seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    noise = initial_latents(gen, sampling, channels=cfg.in_channels)
    print(f"sampling {args.inference_steps} steps, guidance "
          f"{args.guidance}, latents {tuple(noise.shape)} ...")
    _sync(device)
    t0 = time.perf_counter()
    latents = euler_guidance_sample(
        model, noise, text.to(cfg.compute_dtype), text_2.to(cfg.compute_dtype),
        text_mask=mask, num_steps=args.inference_steps,
        guidance=args.guidance, shift=args.flow_shift)
    _sync(device)
    report["sample_s"] = time.perf_counter() - t0
    report["latents"] = latents
    os.makedirs(args.output, exist_ok=True)
    path = os.path.join(args.output, f"{args.name}_latents.pt")
    torch.save(latents.cpu(), path)
    report["path"] = path
    print(f"latents {tuple(latents.shape)}, std {float(latents.std()):.3f} "
          f"({report['sample_s']:.2f} s on {device}); wrote {path}")
    return latents


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None,
         report: Optional[Dict] = None) -> torch.Tensor:
    """Run one request; returns the sampled fp32 latents. A `report` dict
    is filled with the request's parts and the seconds of each stage:
    context, latents, video (rank 0), path, and encode_s, sample_s,
    decode_s, write_s."""
    args = parse_args(argv)
    report = {} if report is None else report
    if args.model == "hunyuanvideo":
        return sample_hunyuan(args, resolve_device(args.device), report)
    device = pmesh.init_distributed(resolve_device(args.device))
    mesh = pmesh.build_mesh(MeshConfig(fsdp=1, context=args.mesh_context),
                            device.type)
    group = pmesh.context_group(mesh)
    ring = None if group is None else DistRing(group)
    main_rank = pmesh.global_rank() == 0
    say = print if main_rank else (lambda *a, **k: None)

    rope_order = args.rope_order
    if rope_order == "auto":
        rope_order = "matched"
        if args.checkpoint and is_torch_reference_checkpoint(args.checkpoint):
            rope_order = "reference"
            say("note: torch reference checkpoint -> rope_order='reference' "
                "(its weights assume the (t,h,w) RoPE table order)")
    model_cfg = demo_config(args.model_width, args.model_depth,
                            args.model_head_dim, args.context_dim, rope_order)
    sampling = SamplingConfig(
        inference_steps=args.inference_steps, cfg_scale=args.cfg_scale,
        height=args.height, width=args.width,
        num_latent_frames=args.num_latent_frames, seed=args.seed)

    checkpoint = None if args.random_weights else args.checkpoint
    if checkpoint is None:
        say("using RANDOM weights (smoke mode)")
    model = load_dit(checkpoint, model_cfg, device)

    encoder = None
    if args.smoke_encoder is not None:
        from video_diffusion_speedrun_tpu_torch.text.encoder import (
            smoke_encoder,
        )

        say(f"smoke encoder: {args.smoke_encoder} RANDOM T5 (embeddings are "
            f"garbage — pipeline exercise only)")
        encoder = smoke_encoder(args.smoke_encoder, args.context_dim, device)
    elif checkpoint is not None:
        from video_diffusion_speedrun_tpu_torch.text.encoder import (
            load_encoder,
        )

        encoder = load_encoder(device=device)
    if encoder is None:
        gen = torch.Generator(device=device).manual_seed(1)
        context = torch.randn(1, 512, args.context_dim, generator=gen,
                              device=device).to(torch.bfloat16) * 0.05
    else:
        if args.prompt is None:
            raise ValueError("--prompt is required to encode a prompt")
        _sync(device)
        t0 = time.perf_counter()
        context = encoder([args.prompt], return_index=args.return_index)
        _sync(device)
        report["encode_s"] = time.perf_counter() - t0
        say(f"encoded the prompt: context {tuple(context.shape)} in "
            f"{1e3 * report['encode_s']:.2f} ms")
        del encoder  # frozen; not needed past the encoding
    report["context"] = context

    say(f"sampling {args.inference_steps} steps, cfg {args.cfg_scale}"
        f"{f', tokens split over {ring.size} ranks' if ring else ''} ...")
    _sync(device)
    t0 = time.perf_counter()
    latents = generate_latents(model, context, sampling,
                               context_parallel=ring)
    _sync(device)
    report["sample_s"] = time.perf_counter() - t0
    report["latents"] = latents
    say(f"latents {tuple(latents.shape)}, std {float(latents.std()):.3f} "
        f"({report['sample_s']:.2f} s on {device})")
    del model

    if main_rank:  # the ranks of a ring hold the same latents
        decoder = load_decoder(args.decoder_weights, device, say)
        _sync(device)
        t0 = time.perf_counter()
        video = decode_video(decoder, latents[0].to(torch.bfloat16),
                             chunk_frames=DECODE_CHUNK)
        _sync(device)
        report["decode_s"] = time.perf_counter() - t0
        report["video"] = video
        t0 = time.perf_counter()
        path = save_video(video, args.output, args.name)
        report["write_s"] = time.perf_counter() - t0
        report["path"] = path
        say(f"decoded {video.shape[1]} frames in {report['decode_s']:.2f} s; "
            f"wrote {path} ({report['write_s']:.2f} s)")
    pmesh.shutdown()
    return latents


if __name__ == "__main__":
    main()
