"""Training entry point of the port: muP-AdamW rectified-flow training of
the video DiT on Cosmos latents, real or synthetic.

    python -m video_diffusion_speedrun_tpu_torch.train --batch_size 64 \\
        --learning_rate 0.015625 --max_steps 5004 --evaluate_every 500 \\
        --model_width 512 --model_depth 24 --model_head_dim 128 \\
        --lr_scheduler_type linear

Flags keep the names and defaults of the JAX package's `train.py` (its
`--platform`, a JAX backend override, has no counterpart; `--scan_blocks`,
an XLA compile option, is accepted and changes nothing). `--remat_policy
attn` keeps the attention outputs across the remat recompute (no attention
forward runs in the backward): the policy for long clips; `dots_attn` also
keeps the linear layers' outputs, at more memory. Runs on the card
by default (`--device cuda`, which raises when no card is present);
`--device cpu` runs on the CPU. `--synthetic_t_choices 5,9,17` mixes
clips of 5, 9 and 17 latent frames (L = 528, 1040 and 2064 at the default
32×32 latents) in shape-uniform batches; L > 2048 takes the long
attention path.

`--optimizer_in_backward true` runs each block's muP-AdamW update inside
the backward's walk over the blocks (`train/inloop.py`): the whole
gradient never exists. With it, `--nu_factored true` keeps large block
weights' second moment rank-1 and `--param_dtype bf16` stores the
parameters in bf16 (refused without it, as JAX's CLI does). The XL
configuration on one card (JAX `bench.py --xl`, 2.76 B parameters, batch
16 of [16, 8, 32, 32] latents, L = 1040):

    python -m video_diffusion_speedrun_tpu_torch.train --model_width 2048 \
        --model_depth 24 --batch_size 16 --synthetic_t_choices 8 \
        --optimizer_in_backward true --nu_factored true \
        --param_dtype bf16 --moments_dtype bf16

The dataset (`--dataset cosmos_openvid`): `--hf_name` a local parquet of
its columns (`python -m video_diffusion_speedrun_tpu_torch.data.fixture`
writes one) or the hub dataset, with the T5 context precomputed per split
(`python -m video_diffusion_speedrun_tpu_torch.data.precompute --split
train --out emb/train`, the same for test):

    python -m video_diffusion_speedrun_tpu_torch.train \\
        --dataset cosmos_openvid --hf_name fixture.parquet \\
        --embeddings_dir emb ...

(`--use_t5` encodes the captions every step instead; with neither,
`--allow_random_context true` trains on random context, smoke runs only.)
Metrics go to `--checkpoint_dir/--run_name/metrics.jsonl`, and to wandb
(`--project_name`) with `--wandb true`.

Checkpoints: every evaluation (`step % evaluate_every == 1`) saves the
full train state to `--checkpoint_dir/--run_name/<step>/`;
`--load_checkpoint` resumes one (a run root or a step directory), or
starts from the weights of a torch reference checkpoint (`.pt` or DCP
directory; `--rope_order auto` then takes the reference's order):

    python -m video_diffusion_speedrun_tpu_torch.train ... \
        --checkpoint_dir ckpts --run_name run1
    python -m video_diffusion_speedrun_tpu_torch.train ... \
        --checkpoint_dir ckpts --run_name run1 --load_checkpoint ckpts/run1

`--use_t5 true` conditions on the T5 encoding of each batch's captions
(hidden state `--return_index`, default -8) from the local FLUX.1-dev
weights; `--smoke_encoder` (a tiny random T5) or `--smoke_encoder xxl`
(T5-XXL with random weights), with the byte-fallback tokenizer, runs that
path without weights.

Across cards, one process per card under `torchrun`, on the mesh
(`--mesh_replica R --mesh_fsdp F --mesh_context C --mesh_tensor T`, R·F·C·T
the number of processes; `--mesh_fsdp` defaults to -1, the rest): R·F data
shards, the global `--batch_size` divisible by R·F; FSDP2 shards the
parameters and moments over F (HSDP: replicated over R); T cards split
each block's heads and MLP columns (tensor parallelism; T divides the
heads); C cards split the tokens of their clips over a ring (context
parallelism). The default flags shard over every card (FSDP):

    torchrun --nproc_per_node 4 -m video_diffusion_speedrun_tpu_torch.train \
        --batch_size 64 ...
    torchrun --nproc_per_node 4 -m video_diffusion_speedrun_tpu_torch.train \
        --mesh_replica 2 --mesh_fsdp 2 --batch_size 64 ...
    torchrun --nproc_per_node 4 -m video_diffusion_speedrun_tpu_torch.train \
        --mesh_fsdp 2 --mesh_tensor 2 --batch_size 64 ...
    torchrun --nproc_per_node 4 -m video_diffusion_speedrun_tpu_torch.train \
        --mesh_fsdp 1 --mesh_context 4 --batch_size 2 --moments_dtype bf16 ...
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from video_diffusion_speedrun_tpu_torch.core.config import (
    DataConfig,
    DiTConfig,
    MeshConfig,
    OptimizerConfig,
    TrainConfig,
)


def _bool(s: str) -> bool:
    if s.lower() in ("true", "1", "yes"):
        return True
    if s.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {s}")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add = p.add_argument
    add("--num_epochs", type=int, default=2)
    add("--batch_size", type=int, default=64)
    add("--learning_rate", type=float, default=1e-4)
    add("--max_steps", type=int, default=10000)
    add("--evaluate_every", type=int, default=20)
    add("--log_every", type=int, default=10)
    add("--model_width", type=int, default=512)
    add("--model_depth", type=int, default=9)
    add("--model_head_dim", type=int, default=128)
    add("--optimizer_type", default="mup_adam")
    add("--lr_scheduler_type", choices=["cosine", "linear", "constant"],
        default="cosine")
    add("--train_bias_and_rms", type=_bool, default=False)
    add("--init_std_factor", type=float, default=0.1)
    add("--rope_order", choices=["auto", "matched", "reference"],
        default="auto")
    add("--dataset", choices=["synthetic", "cosmos_openvid"],
        default="synthetic")
    add("--hf_name", default="fal/cosmos-openvid-1m",
        help="HF dataset name, or a local parquet file/dir with the same "
             "columns (data/fixture.py)")
    add("--cache_dir", default="./cache", help="HF datasets cache dir")
    add("--embeddings_dir", default=None,
        help="dir of shard_*.npy + manifest.json from data/precompute.py "
             "(per-split subdirs or flat): rows get their context, no "
             "per-step T5 encode runs")
    add("--allow_random_context", type=_bool, default=False,
        help="permit random stand-in context when rows carry none and no "
             "prompt encoder is configured (smoke runs only)")
    add("--project_name", default="test_diffusion_test")
    add("--wandb", type=_bool, default=False)
    add("--scan_blocks", type=_bool, default=True,
        help="the JAX package's block scan; accepted, no effect")
    add("--synthetic_rows", type=int, default=4096)
    add("--synthetic_t_choices", default="",
        help="comma-separated latent frame counts for variable-length "
             "synthetic clips (turns on shape bucketing), e.g. 5,9,17")
    add("--seed", type=int, default=0)
    add("--grad_accum", type=int, default=1)
    add("--remat", type=_bool, default=True)
    add("--remat_policy", choices=["nothing", "dots", "attn", "dots_attn"],
        default="nothing",
        help="what the checkpointed backward may reuse: 'dots' saves "
             "matmul outputs; 'attn' saves the flash kernel's o/lse "
             "(skips the O(L²) recompute — the long-context policy); "
             "'dots_attn' both")
    add("--context_dim", type=int, default=4096)
    add("--moments_dtype", choices=["fp32", "bf16"], default="fp32")
    add("--param_dtype", choices=["fp32", "bf16"], default="fp32")
    add("--device", default="cuda")
    add("--run_name", default="diffusion_repa")
    add("--checkpoint_dir", default="checkpoints",
        help="checkpoint root (run subdir = --run_name)")
    add("--load_checkpoint", default=None,
        help="a port checkpoint to resume (run root or step dir), or a "
             "torch reference checkpoint (.pt or DCP dir): weights only")
    add("--use_t5", type=_bool, default=False,
        help="encode captions with T5 (local FLUX.1-dev weights)")
    add("--return_index", type=int, default=-8,
        help="T5 hidden-state index of the captions' context")
    add("--smoke_encoder", nargs="?", const="tiny", choices=["tiny", "xxl"],
        default=None,
        help="with --use_t5: a RANDOM-INIT T5 (tiny, or the XXL config) "
             "and the byte-fallback tokenizer; embeddings are garbage")
    add("--optimizer_in_backward", type=_bool, default=False,
        help="fuse the muP-AdamW update into the backward's walk over the "
             "blocks (train/inloop.py): block gradients never exist all "
             "at once. With --grad_accum N each block's backward runs in "
             "N batch chunks (the same gradients)")
    add("--nu_factored", type=_bool, default=False,
        help="with --optimizer_in_backward: store large block weights' "
             "second moment rank-1 (Adafactor factored nu, momentum exact)")
    # the mesh (core/config.py:MeshConfig)
    for axis in ("replica", "fsdp", "context", "tensor"):
        add(f"--mesh_{axis}", type=int, default=-1 if axis == "fsdp" else 1)
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> TrainConfig:
    """The TrainConfig of the JAX `train.py`, refusing what it refuses."""
    if args.optimizer_type != "mup_adam":
        raise ValueError(f"unknown optimizer type: {args.optimizer_type}")
    if args.param_dtype == "bf16" and not args.optimizer_in_backward:
        # bf16 masters under the standard optimizer round small updates
        # away; the JAX CLI allows them only with optimizer-in-backward
        raise ValueError("--param_dtype bf16 requires --optimizer_in_backward "
                         "true; use --moments_dtype bf16 to halve optimizer "
                         "memory instead")
    if args.smoke_encoder is not None and not args.use_t5:
        raise ValueError("--smoke_encoder chooses the encoder of --use_t5 "
                         "true")
    rope_order = args.rope_order
    if rope_order == "auto":
        from video_diffusion_speedrun_tpu_torch.train.checkpoint import (
            is_torch_reference_checkpoint,
        )

        rope_order = "matched"
        if args.load_checkpoint and is_torch_reference_checkpoint(
                args.load_checkpoint):
            rope_order = "reference"
            print("note: torch reference checkpoint -> rope_order="
                  "'reference' (its weights assume the (t,h,w) RoPE table "
                  "order)")
    model = DiTConfig(
        in_channels=16, patch_size=2, time_patch_size=2,
        hidden_size=args.model_width, depth=args.model_depth,
        num_heads=args.model_width // args.model_head_dim, mlp_ratio=4.0,
        cross_attn_input_size=args.context_dim, residual_v=True,
        train_bias_and_rms=args.train_bias_and_rms, use_rope=True,
        rope_order=rope_order, remat=args.remat,
        remat_policy=args.remat_policy,
        param_dtype=(torch.bfloat16 if args.param_dtype == "bf16"
                     else torch.float32))
    return TrainConfig(
        model=model,
        data=DataConfig(
            dataset=args.dataset, hf_name=args.hf_name,
            cache_dir=args.cache_dir,
            synthetic_rows=args.synthetic_rows, context_dim=args.context_dim,
            synthetic_t_choices=tuple(
                int(t) for t in args.synthetic_t_choices.split(",") if t),
            bucket_by_shape=bool(args.synthetic_t_choices),
            allow_random_context=args.allow_random_context,
            embeddings_dir=args.embeddings_dir),
        mesh=MeshConfig(replica=args.mesh_replica, fsdp=args.mesh_fsdp,
                        context=args.mesh_context, tensor=args.mesh_tensor),
        optimizer=OptimizerConfig(
            learning_rate=args.learning_rate,
            scheduler=args.lr_scheduler_type,
            moments_dtype=(torch.bfloat16 if args.moments_dtype == "bf16"
                           else None),
            in_backward=args.optimizer_in_backward,
            nu_factored=args.nu_factored),
        num_epochs=args.num_epochs, batch_size=args.batch_size,
        grad_accum=args.grad_accum, max_steps=args.max_steps,
        evaluate_every=args.evaluate_every, run_name=args.run_name,
        project_name=args.project_name, wandb=args.wandb,
        seed=args.seed, init_std_factor=args.init_std_factor,
        t5_return_index=args.return_index,
        load_checkpoint=args.load_checkpoint,
        checkpoint_dir=args.checkpoint_dir, log_every=args.log_every)


def build_prompt_encoder(args: argparse.Namespace, device):
    """The `--use_t5` encoder (None without it): the local FLUX.1-dev T5,
    or with `--smoke_encoder` a random one."""
    if not args.use_t5:
        return None
    from video_diffusion_speedrun_tpu_torch.text.encoder import (
        load_encoder,
        smoke_encoder,
    )

    if args.smoke_encoder is not None:
        return smoke_encoder(args.smoke_encoder, args.context_dim, device)
    return load_encoder(device=device)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    cfg = build_config(args)
    from video_diffusion_speedrun_tpu_torch.core.config import resolve_device
    from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer
    from video_diffusion_speedrun_tpu_torch.utils.logging import make_logger

    device = pmesh.init_distributed(resolve_device(args.device))
    make_logger()
    out = Trainer(cfg, device=device,
                  prompt_encoder=build_prompt_encoder(args, device)).train()
    pmesh.shutdown()
    return out


if __name__ == "__main__":
    main()
