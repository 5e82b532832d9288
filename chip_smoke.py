#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab TREE_A TREE_B [PAIRS [TRAIN [SERVE]]]
    python3 chip_smoke.py --adaln-configs
    python3 chip_smoke.py --hyvideo
    torchrun --nproc_per_node N chip_smoke.py --train-mesh STEPS FLAGS...

The second form times the attention backward and forward rows, the AdaLN
backward rows, the bias+GELU backward rows, a serve-long request (ms per Euler step, profiled busy ms)
and the train steps (with `fused_residual` too) of two checkouts' packages
in alternating processes on one card (`main_ab`). The third times the
AdaLN backward under configurations other than its default
(`adaln_configs`). The fourth times the train CLI's configuration of
FLAGS on the mesh of its `--mesh_*` flags over the processes torchrun
starts (`main_train_mesh`): ms per step, a profiled step's device busy ms,
every card's peak memory. The fifth holds HunyuanVideo's kernels against
their twins at its benchmark cell's shapes, times them, and counts their
launches in one run of the sampling CLI at that size (`main_hyvideo`):
the kernels line of those rows, as the first form prints it with the rest.
Run from the root of a checkout. Phases, each of which raises on failure:

1. build   — compile the CUDA kernels from `video_diffusion_speedrun_tpu_torch/
             csrc/` (one nvcc per source, in parallel) and print ptxas's
             register/shared-memory summary;
2. kernels — hold each kernel against its plain twin on the card and time
             kernel, twin and a library call as a yardstick, with each
             kernel's bound from the card's peaks. Forward kernels at the
             sampling shapes (self-attention B=2, L=1040, H=16, D=128;
             cross Lk=512; AdaLN D=2048), and timed beside them at the
             training shapes (B=64, H=4, L=528) and serve-long's
             cross-attention (8208×512); backward kernels at the training
             shapes (B=64, H=4, D=128, L=528, cross Lk=512, and timed beside
             them train-long's cross-attention 8208×512, B=2; the AdaLN
             backward at [64, 528, 512] with x strided and [2, 8208, 512],
             with and without γ, each also against a second launch bit for
             bit, and where its plan and instantiations change, and row 3
             timed at [64, 528, 512]); attention at a ragged shape too
             (L=333, Lk=77); AdamW on leaves of the canonical DiT with fp32
             and bf16 moments, timed over all 299, and on bf16 parameters
             and moments over one XL block's 12 leaves; the factored-ν
             update on one XL block group's 8 factored weights (bf16), 3
             steps against its twin, timed beside its bound and the twin;
3. serve   — sample 2 requests (two seeds, 8 Euler steps, CFG 6.0) with the
             demo DiT (width 2048, depth 24, head 128) at 256×256×8 frames
             through `generate_latents`, the launch counters set to 0 just
             before and read just after; profile one Euler step;
4. parity  — the same model at depth 2 and full width, 2 Euler steps on the
             card against the CPU run of the fused ops' twins in fp32;
5. train   — the canonical 248M DiT (width 512, depth 24, 4 heads of 128,
             batch 64, synthetic [16, 5, 32, 32] latents → L = 528, device
             context 512×4096, remat, muP AdamW at lr 2^-6, linear
             schedule) through the port's `Trainer` and `train_step`: 8
             steps with the launch counters set to 0 before and read after,
             one evaluation, one profiled step;
6. train parity — depth 2, full width: 3 optimizer steps on the card (bf16
             compute, kernels) against the CPU (fp32, twins) on the same
             weights and injected batches;
7. long kernels — the long attention forward and backward (rows 6–7)
             against their twins at L = 8208 (the serve shape B=2, H=16 and
             the train shape B=2, H=4, D=128) and a ragged L = 2100; at
             L = 8208 the same launches against JAX's split-prefix
             decomposition in plain torch (rows 8–9); times beside SDPA
             (the forward at both shapes);
8. serve-long — the demo DiT at the sampling CLI's default 512×512×16
             latent frames (L = 8208) through `generate_latents`: 1 request
             of 8 Euler steps, full width and depth, counters per step;
             profile one Euler step;
9. train-long — the canonical DiT at batch 2, latent [16, 16, 64, 64]
             (L = 8208; JAX `bench.py --longctx`), remat, bf16 moments,
             through `Trainer` and `train_step`: 4 steps, counters per step,
             ms per step, MFU, peak memory; profile one step;
10. long parity — depth 2 at L = 2064 (above the short limit): 2 Euler
             steps of the demo DiT (width 2048) at 256×256×16 frames, and 3
             train steps of the canonical DiT (width 512) on latents
             [16, 17, 32, 32], card (bf16, kernels) against CPU (fp32,
             twins);
11. epilogue kernels — the gated-residual AdaLN forward and backward
             (rows 13–14) against their twins at [2, 1040, 2048] and
             [64, 528, 512] and a ragged L = 333, with and without γ, the
             backward also against a second launch bit for bit; the
             bias+GELU forward and backward (rows 15–16) at the MLP's
             shapes ([2, 1040, 8192], [2, 8208, 8192], [64, 528, 2048],
             [2, 8208, 2048], the tensor-parallel [64, 528, 1024] and
             [64, 528, 512]; the backward not at the first two, which only
             serve, and also at the XL step's [16, 1040, 8192]) and
             L = 333, the MLP's variant and `bias_gelu` on bf16 and fp32
             with and without bias, a width the bulk copies refuse, and
             the MLP's variant at saturated tails (|x| = 4.5, 64, 1e4), the
             backward also against a second launch bit for bit; times
             beside `F.gelu`;
12. fused residual — `DiTConfig.fused_residual`: 2 requests of the demo
             DiT at 256×256×8 through `generate_latents` and 4 train steps
             of the canonical DiT (batch 64, L = 528) through `Trainer` and
             `train_step`, counters per step, one profiled step each; and
             card vs CPU at depth 2 for both, as phases 4 and 6;
13. ring kernels — the ring chunk forward and backward (rows 10–11)
             against their twins at the serve chunk (B=2, H=16, L = 8208
             over cp = 4: chunk 2064, 48 padded kv rows) and the train chunk
             (B=2, H=4, cp = 8: chunk 1040, 112 padded), a chunk that is
             all padding and a ragged Lq ≠ Lk; rows 6–7 with the kv-bias at
             chunk 4112 (cp = 2; row 7 also at 2064, cp = 4); times beside
             SDPA with the bias as mask;
14. serve-cp — context parallelism over `LocalRing(4)` and `LocalRing(2)`
             (every rank's work on this one card): the demo DiT at
             512×512×16 (L = 8208), 1 request of 2 Euler steps each,
             counters per step, against the same request without a ring;
15. train-cp — the train-long configuration over `LocalRing(4)` and
             `LocalRing(8)`, 3 steps each through `Trainer` and
             `train_step`, losses against train-long's on the same batches;
16. cp parity — depth 2 over `LocalRing(4)`, card against CPU: sampling
             at L = 2064, training at L = 528 and 2064;
17. nccl-ring — `DistRing` over NCCL between 2 processes against
             `LocalRing(2)` where the machine has 2 cards; else one line
             says why it did not run;
18. t2v    — the text-to-video request through the sampler CLI's `main`:
             T5-XXL (random bf16 weights, byte-fallback tokenizer) on the
             prompt, the demo DiT (random weights) for 8 of the default 50
             Euler steps at 512×512×16 (L = 8208), the default Cosmos
             decoder (random weights) in chunks of 4 latent frames → 61
             frames of 512², written as `video.npy` to a temporary
             directory and read back; per-stage times, peak memory, and
             the DiT's launches, which must equal serve-long's; then the
             steady encode, the decode with and without `cudnn.benchmark`
             and the two group-norm forms timed, one chunk profiled;
19. t2v parity — card (bf16) vs CPU (fp32) on the same weights: T5 at
             XXL width with 2 layers, the decoder at full width on 3
             latent frames of 16×16, and the whole request at depth 2
             (64×64, 4 latent frames);
20. ckpt   — the canonical DiT (batch 64, L = 528) through the Trainer: 4
             steps at once against 2 steps, a DCP save, a fresh Trainer
             that resumes, 2 more — losses, parameters, moments and
             generator state bit for bit; save/restore seconds and size on
             disk; the checkpoint then feeds the sampler CLI
             (`--checkpoint`, `restore_params_for_inference`);
21. train-t5 — 3 train steps of the canonical DiT with `--use_t5 true
             --smoke_encoder xxl`: T5-XXL re-encodes the 64 captions every
             step, timed beside the step;
22. train-real — the real-data path through the CLIs: a 256-row parquet
             fixture of the dataset's columns (`data/fixture.py`), both
             splits' T5-XXL embeddings (random weights) precomputed with
             `data/precompute.py`, then 16 steps of the canonical DiT
             through the train CLI's `main` with `--dataset cosmos_openvid
             --hf_name … --embeddings_dir …`, one evaluation and
             checkpoint; the precompute per 64 captions, ms per step
             against `train`'s, the training thread's wait per batch, the
             loader alone (rows/s) and `load_tensor` per row; the first
             device batch against its host rows bit for bit, the JAX
             metric keys in `metrics.jsonl`, the launches;
23. train-fsdp — the canonical DiT (batch 64, L = 528, the zero-initialised
             layers made random) sharded by `parallel/fsdp.py`: 3 steps on
             fixed global batches and draws in 2 processes on this one card
             over gloo (NCCL refuses two ranks on one device) at fsdp 2
             (FSDP2) and at tensor 2 (each block's heads and MLP columns
             split), through `Trainer` and `train_step`, each data shard on
             its rows; the losses and the step-1 gradients, gathered whole,
             against one process on the same batches (the limits of CP
             against no ring); the launch counts per rank; the shapes the
             attention and bias+GELU kernels were launched at (the local
             heads and columns) and the AdamW kernel's local leaves. With 2
             cards or more the same over NCCL, one rank a card (fsdp 2 and
             tensor 2; with 4 also replica 2 × fsdp 2 and fsdp 2 × tensor
             2); otherwise one line says why not. Also the
             optimizer-in-backward step with factored ν at fsdp 2 over
             gloo against one process of it;
24. train-inloop — the XL configuration (JAX `bench.py --xl`: width
             2048, depth 24, 16 heads of 128, bf16 parameters, bf16 μ,
             factored ν, optimizer in the backward) through the train
             CLI's `main` at batch 16 of [16, 8, 32, 32] latents (L =
             1040): 4 steps, counters set to 0 before `main` and read
             after (AdamW once per block group and once for the rest,
             in its bf16 mode; the factored-ν kernel twice per block
             group), ms per step, a profiled step's busy ms,
             peak memory; then the standard step at the XL width, batch
             8, fp32 parameters and bf16 moments, the same way; and one
             block's update: the AdamW launch on its exact leaves and the
             factored-ν kernel on its weights, each against its bound;
25. inloop-parity — depth 2, L = 528: the in-backward step with the XL
             optimizer flags on the card against the CPU (fp32, twins),
             and with fp32 parameters against the standard step on the
             card; 3 steps, losses and step-1 gradients at the
             train-parity limits;
26. train-remat — the remat policies (`--remat_policy`) through the train
             CLI's flags: each of "nothing", "dots", "attn" and
             "dots_attn" on train-long's cell (batch 2, L = 8208, bf16
             moments) and "nothing" and "dots_attn" on the standard XL
             step (width 2048, batch 8, L = 1040, fp32 parameters, bf16
             moments): a run each, the zero-initialised layers made
             random; the first step's loss and gradients against
             "nothing" of the cell (within 1e-6 relative; bit equality
             printed), then 4 steps (the first a warm-up) with the
             counters set to 0 before and read after (under "attn" and
             "dots_attn" one attention forward a block, not two), ms per
             step, peak memory from a collected heap, a profiled step;
27. cp-fallback — context parallelism where the ring does not run (the
             gathered attention: each rank's q against k and v gathered
             over the ring), depth 2, over `LocalRing(2)` against no ring
             on the card: the demo DiT without RoPE at 512×512×16 (2
             Euler steps), the canonical DiT without RoPE and at head_dim
             32 in bf16 (3 train steps), at the CP limits; and
             `attention_impl="fused"` at head_dim 32 under CP raises.

Every run of the DiT's MLP launches the bias+GELU kernels. The kernels JSON
lists every kernel with `launches` summed over the main-path runs (serve,
serve-long, serve-cp over 4 and 2, serve with `fused_residual`, t2v,
train, train-long, train-cp over 4 and 8, train with `fused_residual`,
ckpt, train-t5, train-real, each rank of each train-fsdp mesh,
train-inloop's two runs and train-remat's six),
each run with the counters set to 0 just before it and read just after;
the long kernels' kv-bias launches (the ring's fallback) are rows of their
own. The next-to-last
lines are that JSON and the card's name and power limit; the last line is
{"ok": true, "device": {...}}. With no card, or outside a checkout, it
exits non-zero before printing any result.
"""

import dataclasses

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data-sheet peaks (dense)
PEAK_BF16_TC = 989e12  # bf16 tensor-core flop/s
PEAK_FP32 = 67e12  # fp32 flop/s outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s

# demo DiT (video_diffusion_speedrun_tpu sample.py) at 256×256, 8 frames
WIDTH, DEPTH, HEAD_DIM, CTX_DIM, CTX_LEN = 2048, 24, 128, 4096, 512
HEIGHT = WIDTH_PX = 256
FRAMES = 8
STEPS = 8
SEEDS = (42, 43)
ADALN_PER_FORWARD = 3 * DEPTH + 1

# attention: both sides round q, k, p to bf16 at the same points, but the
# online softmax rescales p and sums p·v in another order — about one bf16
# ulp of values of order 1
ATTN_TOL = 2e-2
LSE_TOL = 1e-3
# AdaLN: fp32 inside on both sides, only the row-sum order differs — at most
# one bf16 ulp, 2^-7 of |y|
ADALN_RTOL = 2.0 ** -7
# card (bf16 weights and activations, kernels) against CPU (fp32 twins):
# relative L2 of the 2-step latent update; bf16 rounding through 2 blocks
PARITY_REL_L2 = 5e-2
# attention backward: both sides round p and ds to bf16 at the same points,
# but δ and every product sum in other orders, which can flip a bf16
# rounding of ds and the final rounding of dq/dk/dv: within 2% of each
# gradient's largest magnitude
ATTN_BWD_REL = 2e-2
# AdaLN backward: fp32 inside on both sides; dx within one bf16 ulp plus 1%
# of its scale (cancellation in dn − n·mean(n·dn)); dshift/dscale are fp32
# partial sums in another order, rounded to bf16: one ulp plus 0.1% of scale
ADALN_BWD_RTOL = 2.0 ** -7
# AdamW: the kernel rounds each operation as the JAX leaf math; the twin on
# CUDA divides by bc1/bc2 through a reciprocal: a few ulps of the update,
# whose size is the leaf's lr, plus an ulp of the weight
ADAMW_RTOL, ADAMW_LR_ATOL = 2e-6, 1e-6

# the canonical training DiT (train.py:179-188 of the JAX package, the
# run_debug.sh speedrun configuration)
T_WIDTH, T_DEPTH, T_HEAD_DIM, T_BATCH = 512, 24, 128, 64
T_LATENT = (16, 5, 32, 32)  # Cosmos [C, T, H, W]; T floor-crops to 4
T_L = (T_LATENT[1] // 2) * (T_LATENT[2] // 2) * (T_LATENT[3] // 2) + 16  # 528
T_LR = 2.0 ** -6
T_STEPS = 8
# card (bf16 compute, kernels) against CPU (fp32 twins), depth 2: the loss
# of each of 3 steps within 5% (bf16 activations, and Adam's first steps
# move each weight by about ±lr, so components with a near-zero gradient
# may move the other way); step 1's gradients within 10% relative L2 (bf16
# activations and the bf16 p/ds of the attention backward)
TRAIN_LOSS_REL = 5e-2
TRAIN_GRAD_REL_L2 = 1e-1

# the long path: the demo DiT at the sampling CLI's default size, and the
# canonical DiT at the JAX `bench.py --longctx` shape (bench.py:174-187)
LONG_PX, LONG_FRAMES, LONG_STEPS = 512, 16, 8
LONG_L = (LONG_FRAMES // 2) * (LONG_PX // 16) ** 2 + 16  # 8208
TL_BATCH, TL_STEPS = 2, 4
TL_LATENT = (16, 16, 64, 64)  # [C, T, H, W] → L = 8·32·32 + 16 = 8208
# long-path parity at L = 2064 = 8·16·16 + 16, the smallest long length of
# the model: 16 latent frames at 256×256; latents [16, 17, 32, 32] for
# training (17 frames floor-crop to 16). Training runs at the canonical
# width 512: at width 2048, lr 2^-6 and no warm-up the 3-step trajectory
# diverges on the CPU and the card alike (loss 2.96 → ~300 by step 3)
LP_FRAMES, LP_LATENT = 16, (16, 17, 32, 32)
# long forward against its twin: the same rounding points, the online
# softmax sums in another order, which can flip the last bf16 rounding of
# o: two bf16 ulps of the largest |o|. At L = 8208 o averages v over
# thousands of keys, so |o| is ~0.02 and an absolute 2e-2 would see nothing
LONG_FWD_REL = 2.0 ** -6
# the fused_residual configuration's train run: 4 steps (it serves the
# SEEDS requests, as the default config does)
FR_STEPS = 4
# MLP hidden widths of the demo and the canonical DiT
MLP, T_MLP = 4 * WIDTH, 4 * T_WIDTH
# tensor-parallel sizes whose local shapes (H/t heads, F/t MLP columns of
# the canonical DiT) the kernels phase checks and times
TP_WAYS = (2, 4)
# context parallelism over LocalRing(cp) (every rank's work on this card):
# serving at L = 8208 over cp = 4 (chunk 2064: row 10) and cp = 2 (chunk
# 4112: row 6 with the kv-bias), CP_STEPS Euler steps; training at
# L = 8208 over cp = 4 (row 10 forward, row 7 with the bias backward) and
# cp = 8 (chunk 1040: rows 10 and 11), CP_TRAIN_STEPS steps
CP_SERVE, CP_TRAIN, CP_STEPS, CP_TRAIN_STEPS = (4, 2), (4, 8), 2, 3
# the ring against the same request without one, both bf16 on the card:
# each merge rounds o to bf16 again (JAX's rounding), and the difference
# passes through 24 blocks and CFG 6 — relative L2 of the latent update
CP_REL_L2 = 5e-2
# card vs CPU parity over LocalRing(4) at depth 2 (chunk 528 at L = 2064,
# 144 at L = 528): the limits of the other parity phases
CP_PARITY = 4
# the text-to-video request (t2v): the sampler CLI at its defaults —
# 512×512×16 latent frames, the demo DiT, T5-XXL, the default Cosmos
# decoder in chunks of 4 latent frames → 61 frames — with random weights
# and T2V_STEPS of the default 50 Euler steps
T2V_STEPS = 8
T2V_PROMPT = "a golden retriever running on a beach at sunset"
T2V_FRAMES = 4 * (LONG_FRAMES - 1) + 1  # 61
# t2v parity, card (bf16) vs CPU (fp32) on the same weights, relative L2:
# T5 at XXL width with 2 layers — bf16 products and norms through 2
# layers, ~10 roundings of 2^-8 each; the decoder at full width on 3
# latent frames of 16×16 — ~25 bf16 convs, renormalised by each group
# norm, before a tanh; the whole request (T5 → 2 Euler steps of the DiT at
# depth 2 → decode of 4 latent frames at 8×8) — the DiT parity phases'
# 5e-2 on the latent update, which the decoder carries to the video
T2V_T5_REL_L2, T2V_DECODE_REL_L2, T2V_REQUEST_REL_L2 = 3e-2, 5e-2, 5e-2
# ckpt: the canonical DiT, CKPT_STEPS steps at once against half of them,
# a save, a fresh Trainer that resumes, and the rest — bit for bit
CKPT_STEPS = 4
# train-t5: the canonical DiT on the T5-XXL encoding of its captions
T5_TRAIN_STEPS = 3
# train-real: the canonical DiT through the train CLI on a Cosmos-OpenVid
# parquet fixture of REAL_ROWS rows of T_LATENT (half less 40: 88 train
# rows, one batch of 64 an epoch; 40 test rows, the eval batch) with
# T5-XXL (random weights) context precomputed per split; REAL_STEPS
# epochs of one step, the evaluation and checkpoint after step 1. The
# loader fills its queues (about 5 batches) during that evaluation, so the
# waits of the last REAL_TAIL batches are the steady state's
REAL_ROWS, REAL_STEPS, REAL_TAIL = 256, 16, 8
# batches timed through the loader alone (read, join, collate, pin, copy)
REAL_LOADER_BATCHES = 8
# HunyuanVideo (`models/hunyuan_video.py`) at the benchmark cell's shape:
# 544×960 at 33 frames → latents [16, 9, 68, 120] → a 9 × 34 × 60 token
# grid (18,360 video rows), width 3072 in 24 heads of 128, MLP 12288, and
# a text length of HYV_TXT valid rows of the cell's 64–256 (L = 18,520)
HYV_GRID, HYV_TXT = (9, 34, 60), 160
HYV_IMG = HYV_GRID[0] * HYV_GRID[1] * HYV_GRID[2]
HYV_D, HYV_H, HYV_F = 3072, 24, 12288
# its main-path run: the sampling CLI at that size, HYV_STEPS Euler steps
HYV_STEPS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of `fn` by CUDA events, after warm-up. A ~25 ms
    device sleep ahead of the start event lets the host queue every launch
    first, so host launch overhead (tens of µs for a Triton launch) does
    not stand in for device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, tc_flops: float, fp32_flops: float):
    """Least time (ms) the card needs for the work, and what bounds it."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(tc_flops / PEAK_BF16_TC, fp32_flops / PEAK_FP32)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from video_diffusion_speedrun_tpu_torch.ops import _build

    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(sources)
    log(f"[build] {len(sources)} CUDA source(s) in "
        f"{time.perf_counter() - t0:.1f} s: {', '.join(sources)}")
    for name, (secs, report) in sorted(_build.build_log.items()):
        log(f"[build] {name}.cu: nvcc {secs:.1f} s")
        for line in report.splitlines():
            if "Compiling entry function" in line:
                log("[build]   " + line.split("'")[1])
            elif "Used" in line or "spill" in line or "warning" in line:
                log("[build]     " + line.strip())


def attention_case(dev, lq, lk, rope, gen, b=2, h=WIDTH // HEAD_DIM):
    from video_diffusion_speedrun_tpu_torch.models.rope import rope_cos_sin

    d = HEAD_DIM
    hd = h * d

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    qkv = randn(b, lq, 3 * hd)
    if rope:
        v = randn(b, lq, hd)
        q, k = qkv[..., :hd], qkv[..., hd:2 * hd]
        gh = gw = int(round(((lq - 16) / (FRAMES // 2)) ** 0.5))
        if (FRAMES // 2) * gh * gw + 16 == lq:
            grid = (FRAMES // 2, gh, gw)
        else:  # ragged: tokens on one axis
            grid = (1, 1, lq - 16)
        cos, sin = rope_cos_sin(d, *grid, torch.tensor([3, 5, 7], device=dev),
                                num_registers=16)
    else:
        ckv = randn(b, lk, 2 * hd)
        q, k, v = qkv[..., :hd], ckv[..., :hd], ckv[..., hd:]
        cos = sin = None
    return q, k, v, cos, sin, h, d


def phase_kernels(dev):
    """Each kernel against its twin; times; bounds. Returns the rows of the
    kernels line (without launches)."""
    import torch.nn.functional as F

    from video_diffusion_speedrun_tpu_torch.ops import fused_adaln as fad
    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    real_l = (FRAMES // 2) * (HEIGHT // 16) * (WIDTH_PX // 16) + 16
    serve_h, train_h = WIDTH // HEAD_DIM, T_WIDTH // T_HEAD_DIM
    # (B, H, Lq, Lk): the sampling shape (the kernels line's row), a ragged
    # one, and, checked and timed beside it, the training shapes (also at
    # the tensor-parallel local heads H/t of t = 2 and 4) and serve-long's
    # and train-long's cross-attention
    for rope, name, replaces, shapes in (
            (True, "short_attention_fwd<rope>",
             "video_diffusion_speedrun_tpu/ops/fused_attention.py:813",
             ((2, serve_h, real_l, real_l), (2, serve_h, 333, 333),
              (T_BATCH, train_h, T_L, T_L))
             + tuple((T_BATCH, train_h // t, T_L, T_L) for t in TP_WAYS)),
            (False, "short_attention_fwd<norope>",
             "video_diffusion_speedrun_tpu/ops/fused_attention.py:757",
             ((2, serve_h, real_l, CTX_LEN), (2, serve_h, 333, 77),
              (2, serve_h, LONG_L, CTX_LEN),
              (T_BATCH, train_h, T_L, CTX_LEN))
             + tuple((T_BATCH, train_h // t, T_L, CTX_LEN)
                     for t in TP_WAYS))):
        for b, h, lq, lk in shapes:
            q, k, v, cos, sin, h, d = attention_case(dev, lq, lk, rope, gen,
                                                     b, h)
            scale = d ** -0.5
            o, lse = fa.short_attention_cuda(q, k, v, cos, sin, h, scale)
            po, plse = fa.short_attention_plain(q, k, v, cos, sin, h, scale)
            torch.cuda.synchronize()
            err = (o.float() - po.float()).abs().max().item()
            lerr = (lse - plse).abs().max().item()
            ok = err <= ATTN_TOL and lerr <= LSE_TOL
            log(f"[kernels] {name} B={b} H={h} Lq={lq} Lk={lk}: "
                f"max_abs_err(o) {err:.3e} "
                f"(tol {ATTN_TOL}), max_abs_err(lse) {lerr:.3e} "
                f"(tol {LSE_TOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its twin")
            if lq == 333:
                continue
            ms = cuda_ms(lambda: fa.short_attention_cuda(q, k, v, cos, sin, h,
                                                         scale))
            # yardstick only: SDPA on pre-rotated [B, H, L, D] q/k
            qh, kh, vh = (t.reshape(b, -1, h, d).transpose(1, 2).contiguous()
                          for t in (q, k, v))
            if rope:
                qh = fa._rope_rotate(qh.float(), cos, sin).bfloat16()
                kh = fa._rope_rotate(kh.float(), cos, sin).bfloat16()
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            nbytes = 2 * b * (2 * lq + 2 * lk) * h * d + 4 * b * h * lq
            if rope:
                nbytes += 2 * 4 * lq * d // 2
            tc = 4 * b * h * lq * lk * d
            # rotation (3 flops a rotated element) + softmax (~4 a logit)
            fp32 = 4 * b * h * lq * lk + (3 * b * (lq + lk) * h * d if rope else 0)
            bms, by = bound(nbytes, tc, fp32)
            log(f"[kernels] {name} B={b} H={h} Lq={lq} Lk={lk}: kernel "
                f"{ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {bms:.4f} ms "
                f"({by}), {tc / ms / 1e9:.1f} TFLOP/s")
            if lq != real_l:
                continue
            plain_ms = cuda_ms(lambda: fa.short_attention_plain(
                q, k, v, cos, sin, h, scale), iters=10)
            log(f"[kernels] {name} B={b} H={h} Lq={lq} Lk={lk}: twin "
                f"{plain_ms:.4f} ms")
            rows[name] = dict(name=name, route="cuda",
                              source="video_diffusion_speedrun_tpu_torch/csrc/"
                                     "short_attention_fwd.cu",
                              replaces=replaces, max_abs_err=err, ms=ms,
                              plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                              library_ms=lib_ms)

    name = "adaln_rms_modulate_fwd"
    for l, with_gamma in ((real_l, False), (333, True)):
        x = torch.randn(2, l + 16, WIDTH, generator=gen,
                        device=dev).bfloat16()[:, 16:]
        mod = torch.randn(2, 9 * WIDTH, generator=gen, device=dev).bfloat16()
        shift, scale = mod[:, :WIDTH], mod[:, WIDTH:2 * WIDTH]
        gamma = (torch.randn(WIDTH, generator=gen, device=dev)
                 if with_gamma else None)
        t0 = time.perf_counter()
        y = fad.adaln_rms_modulate(x, shift, scale, gamma)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        want = fad.adaln_rms_modulate_plain(x, shift, scale, gamma)
        diff = (y.float() - want.float()).abs()
        err = diff.max().item()
        ok = bool((diff <= ADALN_RTOL * want.float().abs() + 1e-2).all())
        log(f"[kernels] {name} L={l} gamma={with_gamma}: max_abs_err "
            f"{err:.3e} (tol one bf16 ulp: 2^-7·|y| + 1e-2) "
            f"{'ok' if ok else 'FAIL'}; first call {first_s:.2f} s")
        if not ok:
            raise AssertionError(f"{name} disagrees with its twin")
        if l != real_l:
            continue
        ms = cuda_ms(lambda: fad.adaln_rms_modulate(x, shift, scale))
        plain_ms = cuda_ms(lambda: fad.adaln_rms_modulate_plain(
            x, shift, scale), iters=20)
        n = 2 * l * WIDTH
        bms, by = bound(2 * n * 2 + 2 * 2 * 2 * WIDTH, 0, 5 * n)
        rows[name] = dict(name=name, route="triton",
                          source="video_diffusion_speedrun_tpu_torch/ops/"
                                 "fused_adaln.py",
                          replaces="video_diffusion_speedrun_tpu/ops/"
                                   "fused_adaln.py:68",
                          max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by, library_ms=None)
        log(f"[kernels] {name} L={l}: kernel {ms:.4f} ms, twin "
            f"{plain_ms:.4f} ms, no single library call, bound {bms:.4f} ms "
            f"({by}), {2 * n * 2 / ms / 1e6:.1f} GB/s")
    # the train shape (145 launches a train step), checked with γ, timed
    # as the main path calls it (without: the train CLI's default)
    b, l, d = T_BATCH, T_L, T_WIDTH
    x = torch.randn(b, l, d, generator=gen, device=dev).bfloat16()
    mod = torch.randn(b, 9 * d, generator=gen, device=dev).bfloat16()
    shift, scale = mod[:, :d], mod[:, d:2 * d]
    gamma = torch.randn(d, generator=gen, device=dev)
    y = fad.adaln_rms_modulate(x, shift, scale, gamma)
    want = fad.adaln_rms_modulate_plain(x, shift, scale, gamma)
    diff = (y.float() - want.float()).abs()
    if not bool((diff <= ADALN_RTOL * want.float().abs() + 1e-2).all()):
        raise AssertionError(f"{name} disagrees with its twin at [{b}, {l}, "
                             f"{d}]")
    ms = cuda_ms(lambda: fad.adaln_rms_modulate(x, shift, scale))
    n = b * l * d
    bms, by = bound(2 * n * 2 + 2 * b * d * 2, 0, 5 * n)
    log(f"[kernels] {name} [{b}, {l}, {d}]: max_abs_err (γ) "
        f"{diff.max().item():.3e} ok; kernel (no γ) {ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}), {2 * n * 2 / ms / 1e6:.1f} GB/s")
    del x, y, want, diff
    rows.update(attention_bwd_rows(dev))
    rows.update(adaln_bwd_row(dev))
    rows.update(adamw_row(dev))
    rows.update(adamw_bf16_row(dev))
    rows.update(factored_adamw_row(dev))
    return rows


def check_close(name: str, what: str, got, want, rtol: float, atol: float,
                note: str) -> float:
    """Raise unless |got − want| ≤ atol + rtol·|want| everywhere; log and
    return the max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    atol_s = f"{float(torch.as_tensor(atol).max()):.3e}"  # may be per element
    log(f"[kernels] {name} {what}: max_abs_err {err.max().item():.3e} (tol "
        f"{atol_s} + {rtol:.1e}·|ref|: {note}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its twin ({what})")
    return err.max().item()


def check_deterministic(name: str, what: str, fn, got,
                        outs=("dq", "dk", "dv")) -> None:
    """Raise unless a second launch of `fn` gives the same bits as `got`
    (the outputs `outs`, None where the kernel gives none): the attention
    backward adds its dq partials, the AdaLN backward its column sums, in a
    fixed order."""
    again = fn()
    torch.cuda.synchronize()
    same = all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got, again))
    log(f"[kernels] {name} {what}: a second launch gives "
        f"{'the same bits' if same else 'OTHER BITS'} in {', '.join(outs)} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name} is not deterministic ({what})")


def attention_bwd_rows(dev):
    """Rows 4–5: the backward kernel against its twin, and against a second
    launch bit for bit, at the training shapes and the ragged Lq = 333
    against Lk = 333 and 77; times at the training shapes."""
    import torch.nn.functional as F

    from video_diffusion_speedrun_tpu_torch.models.rope import rope_cos_sin
    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device=dev).manual_seed(5)
    heads, d = T_WIDTH // T_HEAD_DIM, T_HEAD_DIM
    scale = d ** -0.5
    rows = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    for rope, replaces in ((True, "fused_attention.py:873"),
                           (False, "fused_attention.py:1042")):
        name = f"short_attention_bwd<{'rope' if rope else 'norope'}>"
        train_lk = T_L if rope else CTX_LEN
        # (B, H, Lq, Lk); the training shape also at the tensor-parallel
        # local heads H/t
        shapes = ((T_BATCH, heads, T_L, train_lk), (2, heads, 333, 333),
                  (2, heads, 333, 77))
        shapes += tuple((T_BATCH, heads // t, T_L, train_lk)
                        for t in TP_WAYS)
        if not rope:  # train-long's cross-attention, timed beside the row
            shapes += ((2, heads, LONG_L, CTX_LEN),)
        for b, h, lq, lk in shapes:
            hd = h * d
            qkv = randn(b, lq, 3 * hd)
            q = qkv[..., :hd]
            if rope and lk == lq:
                k, v = qkv[..., hd:2 * hd], randn(b, lq, hd)
            if rope:
                grid = (2, 16, 16) if lq == T_L else (1, 1, lq - 16)
                cos, sin = rope_cos_sin(d, *grid, torch.tensor(
                    [3, 5, 7], device=dev), num_registers=16)
            if rope and lk != lq:  # k/v of their own, the q table's rows
                kv = randn(b, lk, 3 * hd)
                k, v = kv[..., hd:2 * hd], kv[..., 2 * hd:]
            elif not rope:
                ckv = randn(b, lk, 2 * hd)
                k, v = ckv[..., :hd], ckv[..., hd:]
                cos = sin = None
            o, lse = fa.short_attention_cuda(q, k, v, cos, sin, h, scale)
            do = randn(b, lq, hd)
            got = fa.short_attention_bwd_cuda(q, k, v, cos, sin, o, lse, do,
                                              h, scale)
            want = fa.short_attention_bwd_plain(q, k, v, cos, sin, o, lse,
                                                do, h, scale)
            torch.cuda.synchronize()
            err = max(check_close(
                name, f"B={b} H={h} Lq={lq} Lk={lk} {gname}", x, y, 0.0,
                ATTN_BWD_REL * y.float().abs().max().item(),
                "2% of the largest |grad|: bf16 p/ds rounding flips under "
                "another summation order")
                for gname, x, y in zip(("dq", "dk", "dv"), got, want))
            check_deterministic(name, f"B={b} H={h} Lq={lq} Lk={lk}",
                                lambda: fa.short_attention_bwd_cuda(
                                    q, k, v, cos, sin, o, lse, do, h, scale),
                                got)
            if lq == 333:
                continue
            del got
            ms = cuda_ms(lambda: fa.short_attention_bwd_cuda(
                q, k, v, cos, sin, o, lse, do, h, scale), iters=20)
            # yardstick only: SDPA's backward on pre-rotated [B, H, L, D]
            qh, kh, vh = (t.reshape(b, -1, h, d).transpose(1, 2).contiguous()
                          for t in (q, k, v))
            if rope:
                qh = fa._rope_rotate(qh.float(), cos, sin).bfloat16()
                kh = fa._rope_rotate(kh.float(), cos, sin).bfloat16()
            qh, kh, vh = (t.requires_grad_() for t in (qh, kh, vh))
            oh = F.scaled_dot_product_attention(qh, kh, vh)
            doh = do.reshape(b, lq, h, d).transpose(1, 2).contiguous()
            lib_ms = cuda_ms(lambda: torch.autograd.grad(
                oh, (qh, kh, vh), doh, retain_graph=True), iters=20)
            del oh
            # reads q, k, v, o, do (+ lse, cos/sin), writes dq, dk, dv
            nbytes = (2 * b * hd * (3 * lq + 2 * lk) + 4 * b * h * lq
                      + 2 * b * hd * (lq + 2 * lk))
            if rope:
                nbytes += 2 * 4 * lq * d // 2
            tc = 10 * b * h * lq * lk * d  # useful flops, as JAX counts them
            # exp2, p·(dp − δ) (~4 a logit) and the rotations
            fp32 = 4 * b * h * lq * lk + (6 * b * (lq + lk) * hd if rope else 0)
            bms, by = bound(nbytes, tc, fp32)
            log(f"[kernels] {name} B={b} H={h} Lq={lq} Lk={lk}: kernel "
                f"{ms:.4f} ms, SDPA backward {lib_ms:.4f} ms, bound "
                f"{bms:.4f} ms ({by}), {tc / ms / 1e9:.1f} useful TFLOP/s")
            if lq != T_L or h != heads:
                continue
            plain_ms = cuda_ms(lambda: fa.short_attention_bwd_plain(
                q, k, v, cos, sin, o, lse, do, h, scale), iters=3, warmup=1)
            log(f"[kernels] {name} B={b} Lq={lq} Lk={lk}: twin "
                f"{plain_ms:.4f} ms")
            rows[name] = dict(
                name=name, route="cuda",
                source="video_diffusion_speedrun_tpu_torch/csrc/"
                       "short_attention_bwd.cu",
                replaces="video_diffusion_speedrun_tpu/ops/" + replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
    return rows


# AdaLN backward (rows 12 and 14) against its twin: name → (rtol, atol as
# a share of max|ref|, note); row 14's dγ keeps its own atol
ADALN_BWD_TOLS = {
    "dx": (ADALN_BWD_RTOL, 1e-2, "one bf16 ulp + 1% of scale: row-sum "
                                 "order"),
    "dshift": (ADALN_BWD_RTOL, 1e-3, "one bf16 ulp + 0.1% of scale: "
                                     "column-sum order"),
    "dgamma": (1e-4, 1e-6, "fp32 column sums over B·L rows in another "
                           "order")}
ADALN_BWD_TOLS["dscale"] = ADALN_BWD_TOLS["dshift"]
GR_BWD_TOLS = dict(ADALN_BWD_TOLS, ddelta=ADALN_BWD_TOLS["dx"],
                   dgate=ADALN_BWD_TOLS["dshift"],
                   dgamma=(1e-4, 1e-3, ADALN_BWD_TOLS["dshift"][2]))
ADALN_BWD_NAMES = ("dx", "dshift", "dscale", "dgamma")
GR_BWD_NAMES = ("dx", "ddelta", "dgate", "dshift", "dscale", "dgamma")
# the AdaLN backward beyond the main path's shapes, where its plan and its
# instantiations change — (B, L, D, dtype): B = 1; L shorter than one ring
# stage; runs that cross many b boundaries (L = 7); L = 333; D = 2048
# (partials in shared memory); D = 520 (32 columns a lane); D = 100 (rows
# of 200 bytes: the masked loads); fp32 rows
ADALN_BWD_CASES = ((1, 333, 512, torch.bfloat16), (3, 2, 512, torch.bfloat16),
                   (5, 7, 512, torch.bfloat16), (3, 333, 512, torch.bfloat16),
                   (2, 333, 2048, torch.bfloat16),
                   (2, 40, 520, torch.bfloat16), (3, 37, 100, torch.bfloat16),
                   (4, 100, 512, torch.float32))


def check_adaln_bwd(name: str, what: str, names, got, want, tols) -> float:
    """Each gradient of an AdaLN backward against the twin's within its
    limit of `tols`; returns the max abs error."""
    err = 0.0
    for gname, a, w in zip(names, got, want):
        if w is None:
            if a is not None:
                raise AssertionError(f"{name} {what}: {gname} is not None")
            continue
        rtol, rel, note = tols[gname]
        err = max(err, check_close(name, f"{what} {gname}", a, w, rtol,
                                   rel * w.float().abs().max().item(), note))
    return err


def adaln_bwd_bound(b: int, l: int, d: int, esize: int, gamma: bool,
                    gated: bool):
    """Row 12 reads x and g and writes dx; row 14 reads x_new, δ, gx, gy and
    writes dx and dδ; both read scale (and gate, γ) and write the [B, D]
    sums (and dγ); ~14 fp32 flops an element (row 14: ~20)."""
    n = b * l * d
    nbytes = (6 if gated else 3) * n * esize + (5 if gated else 3) * b * d * 2
    nbytes += 2 * d * 4 if gamma else 0
    return bound(nbytes, 0, (20 if gated else 14) * n)


def adaln_bwd_row(dev):
    """Row 12: the CUDA backward (csrc/adaln_bwd.cu) against its twin and
    against a second launch bit for bit, with γ and without (the main
    path's case: the train CLI's `--train_bias_and_rms` defaults to False,
    as JAX's train.py): at the train shape [64, 528, 512] with x strided as
    the final layer passes it, at train-long's [2, 8208, 512], and at
    ADALN_BWD_CASES; times at the first two."""
    from video_diffusion_speedrun_tpu_torch.ops import fused_adaln as fad

    name = "adaln_rms_modulate_bwd"
    gen = torch.Generator(device=dev).manual_seed(6)
    err, row = 0.0, None
    # (B, L, D, dtype, x strided, timed)
    cases = [(T_BATCH, T_L, T_WIDTH, torch.bfloat16, True, True),
             (2, LONG_L, T_WIDTH, torch.bfloat16, False, True)]
    cases += [(*c, True, False) for c in ADALN_BWD_CASES]
    for b, l, d, dtype, strided, timed in cases:
        x = torch.randn(b, l + 16, d, generator=gen, device=dev).to(dtype)
        x = x[:, 16:] if strided else x[:, :l].contiguous()
        mod = torch.randn(b, 9 * d, generator=gen, device=dev).to(dtype)
        shift, scale = mod[:, :d], mod[:, d:2 * d]
        g = torch.randn(b, l, d, generator=gen, device=dev).to(dtype)
        for gamma in (torch.randn(d, generator=gen, device=dev), None):
            what = f"[{b}, {l}, {d}] {dtype} gamma={gamma is not None}"

            def run():
                return fad.adaln_rms_modulate_bwd(x, shift, scale, gamma, g)

            got = run()
            want = fad.adaln_rms_modulate_bwd_plain(x, shift, scale, gamma, g)
            torch.cuda.synchronize()
            err = max(err, check_adaln_bwd(name, what, ADALN_BWD_NAMES, got,
                                           want, ADALN_BWD_TOLS))
            check_deterministic(name, what, run, got, ADALN_BWD_NAMES)
            del got, want
            if not timed:
                continue
            ms = cuda_ms(run)
            bms, by = adaln_bwd_bound(b, l, d, 2, gamma is not None, False)
            log(f"[kernels] {name} {what}: kernel {ms:.4f} ms, bound "
                f"{bms:.4f} ms ({by}), {3 * b * l * d * 2 / ms / 1e6:.1f} "
                f"GB/s of rows")
            if l == T_L and gamma is None:
                plain_ms = cuda_ms(lambda: fad.adaln_rms_modulate_bwd_plain(
                    x, shift, scale, gamma, g), iters=10)
                log(f"[kernels] {name} {what}: twin {plain_ms:.4f} ms, no "
                    f"single library call")
                row = (ms, plain_ms, bms, by)
        del x, g, mod
    ms, plain_ms, bms, by = row
    return {name: dict(
        name=name, route="cuda",
        source="video_diffusion_speedrun_tpu_torch/csrc/adaln_bwd.cu",
        replaces="video_diffusion_speedrun_tpu/ops/fused_adaln.py:156",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=None)}


def adamw_row(dev):
    """Row 17: the multi-tensor kernel against its twin on a handful of
    canonical leaves (fp32 and bf16 moments, 3 steps), then timed over
    all 299 leaves of the canonical DiT."""
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT
    from video_diffusion_speedrun_tpu_torch.ops import fused_adamw as fw

    name = "adamw_multi_tensor"
    gen = torch.Generator(device=dev).manual_seed(7)
    b1, b2, eps = 0.95, 0.99, 1e-8
    shapes = [(1536, 512), (2048, 512), (512, 2048), (1024, 4096),
              (4608, 512), (512,), (1,)]
    err = 0.0
    for mdt in (torch.float32, torch.bfloat16):
        ps = [torch.randn(s, generator=gen, device=dev) * 0.02 for s in shapes]
        twin = [p.clone() for p in ps]
        ms_, vs = ([torch.zeros_like(p, dtype=mdt) for p in ps]
                   for _ in "mv")
        mt, vt = [m.clone() for m in ms_], [v.clone() for v in vs]
        lrs = [T_LR * 32 / s[-1] for s in shapes]
        wds = [0.1 * s[-1] / 1024 for s in shapes]
        kern = fw.MultiTensorAdamW(ps, ms_, vs, lrs, wds, b1, b2, eps)
        for step in range(3):
            grads = [torch.randn(s, generator=gen, device=dev) for s in shapes]
            sc = fw.step_scalars(step, 1.0 - step / 8, b1, b2)
            kern(grads, *sc)
            for i, g in enumerate(grads):
                fw.adamw_leaf_update_plain(twin[i], mt[i], vt[i], g, lrs[i],
                                           wds[i], *sc, b1, b2, eps)
        torch.cuda.synchronize()
        lr_atol = torch.cat([torch.full((p.numel(),), ADAMW_LR_ATOL * lr,
                                        device=dev) for p, lr in zip(ps, lrs)])
        flat = [torch.cat([t.flatten() for t in ts])
                for ts in (ps, twin, ms_ + vs, mt + vt)]
        what = f"moments={str(mdt)[6:]} {len(shapes)} leaves 3 steps"
        err = max(err, check_close(
            name, what + " p", flat[0], flat[1], ADAMW_RTOL, lr_atol,
            "1e-6·lr: the twin divides by bc1/bc2 through a reciprocal"))
        err = max(err, check_close(name, what + " m, v", flat[2], flat[3],
                                   0.0, 0.0, "no division: bit-equal"))

    model = DiT(train_config(T_DEPTH), device=dev, seed=0)
    params = [p.detach() for p in model.parameters()]
    grads = [torch.randn(p.shape, generator=gen, device=dev) * 1e-3
             for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    n = sum(p.numel() for p in params)
    kern = fw.MultiTensorAdamW(params, m, v, [1e-3] * len(params),
                               [0.0] * len(params), b1, b2, eps)
    sc = fw.step_scalars(0, 1.0, b1, b2)
    ms = cuda_ms(lambda: kern(grads, *sc), iters=10, warmup=2)

    def twin_step():
        for p, mm, vv, g in zip(params, m, v, grads):
            fw.adamw_leaf_update_plain(p, mm, vv, g, 1e-3, 0.0, *sc, b1, b2,
                                       eps)

    plain_ms = cuda_ms(twin_step, iters=3, warmup=1)
    # yardstick only: PyTorch's fused AdamW over the same leaves, one lr
    for p, g in zip(params, grads):
        p.grad = g
    lib = torch.optim.AdamW(params, lr=1e-3, betas=(b1, b2), eps=eps,
                            weight_decay=0.0, fused=True)
    lib_ms = cuda_ms(lib.step, iters=10, warmup=2)
    bms, by = bound(28 * n, 0, 15 * n)  # reads p, g, m, v; writes p, m, v
    log(f"[kernels] {name}: {len(params)} leaves, {n / 1e6:.1f} M params, "
        f"fp32 moments: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
        f"torch AdamW(fused) {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{28 * n / ms / 1e6:.1f} GB/s")
    del model, lib, params, grads, m, v
    torch.cuda.empty_cache()
    return {name: dict(
        name=name, route="cuda",
        source="video_diffusion_speedrun_tpu_torch/csrc/adamw_multi_tensor.cu",
        replaces="video_diffusion_speedrun_tpu/ops/fused_adamw.py:66",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=lib_ms)}


def long_inputs(dev, gen, b: int, lq: int, lk: int, h: int):
    """bf16 q [B, Lq, H·D] and k, v [B, Lk, H·D] for the long kernels: at
    L = 8208 q and k rotated by the serve shape's RoPE tables (as the model
    hands them over, contiguous) and v strided out of qkv; at other lengths
    all three strided out of qkv, as the no-RoPE model hands them over."""
    from video_diffusion_speedrun_tpu_torch.models.rope import rope_cos_sin
    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa

    hd = h * HEAD_DIM
    qkv = torch.randn(b, lq, 3 * hd, generator=gen, device=dev).bfloat16()
    kv = qkv if lk == lq else torch.randn(b, lk, 3 * hd, generator=gen,
                                          device=dev).bfloat16()
    q, k, v = qkv[..., :hd], kv[..., hd:2 * hd], kv[..., 2 * hd:]
    if lq == lk == LONG_L:
        grid = (LONG_FRAMES // 2, LONG_PX // 16, LONG_PX // 16)
        cos, sin = rope_cos_sin(HEAD_DIM, *grid, torch.tensor(
            [3, 5, 7], device=dev), num_registers=16)
        q, k = (fa.rotate_flat(t, cos, sin, h) for t in (q, k))
    return q, k, v


def attention_bounds(b, h, lq, lk, d, backward: bool):
    """(bound ms, what bounds it) of attention over [B, H, Lq/Lk, D] bf16:
    forward reads q, k, v and writes o, lse (4·B·H·Lq·Lk·D tensor flops,
    ~5 fp32 flops a logit: the scale and the softmax); backward reads q, k,
    v, o, do, lse and writes dq, dk, dv (10·B·H·Lq·Lk·D useful tensor
    flops, the JAX count; ~4 fp32 flops a logit)."""
    hd = h * d
    if not backward:
        return bound(2 * b * (2 * lq + 2 * lk) * hd + 4 * b * h * lq,
                     4 * b * h * lq * lk * d, 5 * b * h * lq * lk)
    return bound(2 * b * hd * (3 * lq + 2 * lk) + 4 * b * h * lq
                 + 2 * b * hd * (lq + 2 * lk),
                 10 * b * h * lq * lk * d, 4 * b * h * lq * lk)


def long_attention_rows(dev):
    """Rows 6–9: the long kernels against their twins at L = 8208 (serve
    and train shapes) and a ragged L = 2100, and at L = 8208 against the
    split-prefix plain version; times beside SDPA at the main-path shapes
    (forward: serve, backward: train)."""
    import torch.nn.functional as F

    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device=dev).manual_seed(11)
    d = HEAD_DIM
    scale = d ** -0.5
    serve_h, train_h = WIDTH // HEAD_DIM, T_WIDTH // T_HEAD_DIM
    src = "video_diffusion_speedrun_tpu_torch/csrc/long_attention_{}.cu"
    rep = "video_diffusion_speedrun_tpu/ops/fused_attention.py:{}"
    n_pfx = fa._split_prefix(LONG_L, LONG_L, fa.DEFAULT_BLOCK)
    rows, errs = {}, {}

    def fwd_check(name, what, got, want):
        (o, lse), (wo, wlse) = got, want
        err = check_close(name, what + " o", o, wo, 0.0,
                          LONG_FWD_REL * wo.float().abs().max().item(),
                          "two bf16 ulps of the largest |o|: the online "
                          "softmax sums in another order")
        check_close(name, what + " lse", lse, wlse, 0.0, LSE_TOL,
                    "fp32 sums in another order")
        errs[name] = max(errs.get(name, 0.0), err)

    def bwd_check(name, what, got, want):
        for gname, x, y in zip(("dq", "dk", "dv"), got, want):
            err = check_close(
                name, f"{what} {gname}", x, y, 0.0,
                ATTN_BWD_REL * y.float().abs().max().item(),
                "2% of the largest |grad|: bf16 p/ds rounding flips under "
                "another summation order")
            errs[name] = max(errs.get(name, 0.0), err)

    def heads(*ts):
        return [t.reshape(t.shape[0], t.shape[1], -1, d).transpose(1, 2)
                .contiguous() for t in ts]

    for b, l, h in ((2, LONG_L, serve_h), (2, LONG_L, train_h),
                    (2, 2100, train_h)):
        q, k, v = long_inputs(dev, gen, b, l, l, h)
        what = f"B={b} H={h} Lq=Lk={l}"
        got = fa.long_attention_cuda(q, k, v, h, scale)
        fwd_check("long_attention_fwd", what, got,
                  fa.long_attention_plain(q, k, v, h, scale))
        if l != LONG_L:
            continue
        fwd_check("long_attention_fwd<split>", what + f" n_pfx={n_pfx}", got,
                  fa.split_attention_plain(q, k, v, h, scale, n_pfx))
        ms = cuda_ms(lambda: fa.long_attention_cuda(q, k, v, h, scale),
                     iters=10, warmup=2)
        qh, kh, vh = heads(q, k, v)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh),
                         iters=10, warmup=2)
        del qh, kh, vh
        bms, by = attention_bounds(b, h, l, l, d, backward=False)
        log(f"[kernels] long_attention_fwd {what}: kernel {ms:.4f} ms, SDPA "
            f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{4 * b * h * l * l * d / ms / 1e9:.1f} TFLOP/s")
        if h != serve_h:
            continue
        plain_ms = cuda_ms(lambda: fa.long_attention_plain(q, k, v, h, scale),
                           iters=3, warmup=1)
        split_ms = cuda_ms(lambda: fa.split_attention_plain(
            q, k, v, h, scale, n_pfx), iters=3, warmup=1)
        log(f"[kernels] long_attention_fwd {what}: twin {plain_ms:.4f} ms, "
            f"split plain version {split_ms:.4f} ms")
        for name, line, pms in (("long_attention_fwd", 251, plain_ms),
                                ("long_attention_fwd<split>", 1468, split_ms)):
            rows[name] = dict(name=name, route="cuda", source=src.format("fwd"),
                              replaces=rep.format(line), ms=ms, plain_ms=pms,
                              bound_ms=bms, bound_by=by, library_ms=lib_ms)

    for b, l, h in ((2, LONG_L, train_h), (2, 2100, train_h)):
        q, k, v = long_inputs(dev, gen, b, l, l, h)
        what = f"B={b} H={h} Lq=Lk={l}"
        o, lse = fa.long_attention_cuda(q, k, v, h, scale)
        do = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
        args = (q, k, v, o, lse, do, h, scale)
        got = fa.long_attention_bwd_cuda(*args)
        bwd_check("long_attention_bwd", what, got,
                  fa.long_attention_bwd_plain(*args))
        check_deterministic("long_attention_bwd", what,
                            lambda: fa.long_attention_bwd_cuda(*args), got)
        if l != LONG_L:
            continue
        bwd_check("long_attention_bwd<split>", what + f" n_pfx={n_pfx}", got,
                  fa.split_attention_bwd_plain(*args, n_pfx))
        del got
        ms = cuda_ms(lambda: fa.long_attention_bwd_cuda(*args), iters=10,
                     warmup=2)
        plain_ms = cuda_ms(lambda: fa.long_attention_bwd_plain(*args),
                           iters=2, warmup=1)
        split_ms = cuda_ms(lambda: fa.split_attention_bwd_plain(*args, n_pfx),
                           iters=2, warmup=1)
        qh, kh, vh = (t.requires_grad_() for t in heads(q, k, v))
        oh = F.scaled_dot_product_attention(qh, kh, vh)
        (doh,) = heads(do)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            oh, (qh, kh, vh), doh, retain_graph=True), iters=10, warmup=2)
        del oh
        bms, by = attention_bounds(b, h, l, l, d, backward=True)
        log(f"[kernels] long_attention_bwd {what}: kernel {ms:.4f} ms, twin "
            f"{plain_ms:.4f} ms, split plain version {split_ms:.4f} ms, SDPA "
            f"backward {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{10 * b * h * l * l * d / ms / 1e9:.1f} useful TFLOP/s")
        for name, line, pms in (("long_attention_bwd", 534, plain_ms),
                                ("long_attention_bwd<split>", 1596, split_ms)):
            rows[name] = dict(name=name, route="cuda", source=src.format("bwd"),
                              replaces=rep.format(line), ms=ms, plain_ms=pms,
                              bound_ms=bms, bound_by=by, library_ms=lib_ms)
    for name, row in rows.items():
        row["max_abs_err"] = errs[name]
    torch.cuda.empty_cache()
    return rows


def ring_inputs(dev, gen, b: int, h: int, l: int, cp: int, i: int, j: int,
                lq=None, lk=None):
    """Rank i's q chunk and kv chunk j of a context-parallel split of L
    tokens over cp ranks (chunk = ⌈L/(cp·16)⌉·16), as the model hands them
    to the ring: bf16 q, k, v strided out of qkv-laid-out tensors, the
    chunks' rows of the model's RoPE table padded to cp·chunk rows, and
    chunk j's kv-bias (−1e30 on the padded tail). `lq`/`lk` cut the chunks
    for a ragged case."""
    import torch.nn.functional as F

    from video_diffusion_speedrun_tpu_torch.models.rope import rope_cos_sin
    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa

    chunk, lp = fa.ring_layout(l, cp)
    lq, lk = min(lq or chunk, chunk), min(lk or chunk, chunk)
    hd = h * HEAD_DIM
    grid = ((LONG_FRAMES // 2, LONG_PX // 16, LONG_PX // 16) if l == LONG_L
            else (1, 1, l - 16))
    cos, sin = (F.pad(t, (0, 0, 0, lp - l)) for t in rope_cos_sin(
        HEAD_DIM, *grid, torch.tensor([3, 5, 7], device=dev),
        num_registers=16))
    kbias = fa.ring_kbias(l, lp, dev)
    qr, kr = slice(i * chunk, i * chunk + lq), slice(j * chunk, j * chunk + lk)
    q = torch.randn(b, lq, 3 * hd, generator=gen, device=dev).bfloat16()
    kv = torch.randn(b, lk, 3 * hd, generator=gen, device=dev).bfloat16()
    tabs = (cos[qr], sin[qr], cos[kr], sin[kr])
    return q[..., :hd], kv[..., hd:2 * hd], kv[..., 2 * hd:], tabs, \
        kbias[kr].contiguous()


def ring_attention_rows(dev):
    """Rows 10–11 against their twins at the serve chunk (B=2, H=16, L =
    8208 over cp = 4: chunk 2064, rank 0's q against the last chunk, 48
    padded kv rows) and the train chunk (B=2, H=4, cp = 8: chunk 1040,
    112 padded), a chunk that is all padding (L = 17, cp = 4) and a ragged
    Lq ≠ Lk; rows 6–7 with the kv-bias at chunk 4112 (cp = 2) and row 7's
    at chunk 2064 (cp = 4, the train-cp4 shape). Times beside
    the bound, the twin and SDPA with the bias as `attn_mask` over the
    pre-rotated chunk."""
    import torch.nn.functional as F

    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device=dev).manual_seed(15)
    d = HEAD_DIM
    scale = d ** -0.5
    serve_h, train_h = WIDTH // HEAD_DIM, T_WIDTH // T_HEAD_DIM
    rep = "video_diffusion_speedrun_tpu/ops/fused_attention.py:{}"
    src = "video_diffusion_speedrun_tpu_torch/csrc/{}.cu"
    rows, errs = {}, {}

    def fwd_check(name, what, got, want):
        (o, lse), (wo, wlse) = got, want
        err = check_close(name, what + " o", o, wo, 0.0,
                          LONG_FWD_REL * wo.float().abs().max().item(),
                          "two bf16 ulps of the largest |o|: the online "
                          "softmax sums in another order")
        finite = bool(torch.isfinite(o.float()).all()
                      and torch.isfinite(lse).all())
        masked = bool((wlse < -1e29).all())
        if masked:  # a chunk of padding: lse ≈ −1e30 on both sides
            ok = finite and bool((lse < -1e29).all())
            log(f"[kernels] {name} {what} lse: {lse.max().item():.3e} on a "
                f"chunk of padding (want ≈ −1e30, finite) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}: a masked chunk is not finite")
        else:
            check_close(name, what + " lse", lse, wlse, 0.0, LSE_TOL,
                        "fp32 sums in another order")
        errs[name] = max(errs.get(name, 0.0), err)

    def bwd_check(name, what, got, want):
        for gname, x, y in zip(("dq", "dk", "dv"), got, want):
            err = check_close(
                name, f"{what} {gname}", x, y, 0.0,
                ATTN_BWD_REL * y.float().abs().max().item(),
                "2% of the largest |grad|: bf16 p/ds rounding flips under "
                "another summation order")
            errs[name] = max(errs.get(name, 0.0), err)

    def heads(*ts):
        return [t.reshape(t.shape[0], t.shape[1], -1, d).transpose(1, 2)
                .contiguous() for t in ts]

    def sdpa_args(q, k, v, tabs, kbias):
        """Pre-rotated [B, H, L, D] q, k, v and the bias as a bf16 mask."""
        qr = fa.rotate_flat(q, tabs[0], tabs[1], q.shape[-1] // d)
        kr = fa.rotate_flat(k, tabs[2], tabs[3], k.shape[-1] // d)
        return (*heads(qr, kr, v),
                kbias.bfloat16()[None, None, None, :])

    def record(name, src_name, line, ms, plain_ms, lib_ms, bms, by):
        rows[name] = dict(name=name, route="cuda", source=src.format(src_name),
                          replaces=rep.format(line), ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by, library_ms=lib_ms)

    # row 10: serve chunk (timed), train chunk, padding chunk, ragged
    for b, h, l, cp, j, lq, lk, timed in (
            (2, serve_h, LONG_L, 4, 3, None, None, True),
            (2, train_h, LONG_L, 8, 7, None, None, False),
            (2, train_h, 17, 4, 2, None, None, False),
            (2, train_h, LONG_L, 4, 3, 333, None, False)):
        q, k, v, tabs, kbias = ring_inputs(dev, gen, b, h, l, cp, 0, j, lq,
                                           lk)
        what = (f"B={b} H={h} L={l} cp={cp} chunk 0 vs {j}: Lq={q.shape[1]} "
                f"Lk={k.shape[1]}, {int((kbias < 0).sum())} padded kv rows")
        args = (q, k, v, *tabs, kbias, h, scale)
        got = fa.ring_attention_cuda(*args)
        fwd_check("ring_attention_fwd", what, got, fa.ring_chunk_plain(*args))
        if not timed:
            continue
        ms = cuda_ms(lambda: fa.ring_attention_cuda(*args), iters=20)
        plain_ms = cuda_ms(lambda: fa.ring_chunk_plain(*args), iters=3,
                           warmup=1)
        qh, kh, vh, mask = sdpa_args(q, k, v, tabs, kbias)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), iters=20)
        bms, by = attention_bounds(b, h, q.shape[1], k.shape[1], d,
                                   backward=False)
        record("ring_attention_fwd", "ring_attention_fwd", 1185, ms,
               plain_ms, lib_ms, bms, by)
        log(f"[kernels] ring_attention_fwd {what}: kernel {ms:.4f} ms, twin "
            f"{plain_ms:.4f} ms, SDPA with the bias as mask {lib_ms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), "
            f"{4 * b * h * q.shape[1] * k.shape[1] * d / ms / 1e9:.1f} "
            f"TFLOP/s")

    # row 11 (kv up to its 2048 ceiling): train chunk (timed), serve-width
    # chunk cut to 2048 kv, ragged; o and lse are the chunk's own
    # forward's (one chunk: the merged ones)
    for b, h, l, cp, j, lq, lk, timed in (
            (2, train_h, LONG_L, 8, 7, None, None, True),
            (2, serve_h, LONG_L, 4, 3, None, 2048, False),
            (2, train_h, LONG_L, 8, 7, 333, None, False)):
        q, k, v, tabs, kbias = ring_inputs(dev, gen, b, h, l, cp, 0, j, lq,
                                           lk)
        what = (f"B={b} H={h} L={l} cp={cp} chunk 0 vs {j}: Lq={q.shape[1]} "
                f"Lk={k.shape[1]}, {int((kbias < 0).sum())} padded kv rows")
        o, lse = fa.ring_attention_cuda(q, k, v, *tabs, kbias, h, scale)
        do = torch.randn(o.shape, generator=gen, device=dev).bfloat16()
        args = (q, k, v, *tabs, kbias, o, lse, do, h, scale)
        got = fa.ring_attention_bwd_cuda(*args)
        bwd_check("ring_attention_bwd", what, got,
                  fa.ring_chunk_bwd_plain(*args))
        check_deterministic("ring_attention_bwd", what,
                            lambda: fa.ring_attention_bwd_cuda(*args), got)
        if not timed:
            continue
        del got
        ms = cuda_ms(lambda: fa.ring_attention_bwd_cuda(*args), iters=20)
        plain_ms = cuda_ms(lambda: fa.ring_chunk_bwd_plain(*args), iters=3,
                           warmup=1)
        qh, kh, vh, mask = sdpa_args(q, k, v, tabs, kbias)
        qh, kh, vh = (t.requires_grad_() for t in (qh, kh, vh))
        oh = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        (doh,) = heads(do)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            oh, (qh, kh, vh), doh, retain_graph=True), iters=20)
        del oh
        bms, by = attention_bounds(b, h, q.shape[1], k.shape[1], d,
                                   backward=True)
        record("ring_attention_bwd", "ring_attention_bwd", 1235, ms,
               plain_ms, lib_ms, bms, by)
        log(f"[kernels] ring_attention_bwd {what}: kernel {ms:.4f} ms, twin "
            f"{plain_ms:.4f} ms, SDPA backward with the bias as mask "
            f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{10 * b * h * q.shape[1] * k.shape[1] * d / ms / 1e9:.1f} "
            f"useful TFLOP/s")

    # row 11 against a kv chunk that is all padding (L = 17 over cp = 4:
    # chunk 2), from the o and lse of q's own chunk (finite, as the merged
    # ones are) and from the padding chunk's own (lse ≈ −1e30): p is 0 on
    # every padded row, so dq, dk and dv are exactly 0, finite either way
    q, k, v, tabs, kbias = ring_inputs(dev, gen, 2, train_h, 17, 4, 0, 2)
    own = ring_inputs(dev, gen, 2, train_h, 17, 4, 0, 0)
    for src_lse, (o, lse) in (
            ("q's own chunk", fa.ring_attention_cuda(
                q, own[1], own[2], *own[3], own[4], train_h, scale)),
            ("the padding chunk", fa.ring_attention_cuda(
                q, k, v, *tabs, kbias, train_h, scale))):
        do = torch.randn(o.shape, generator=gen, device=dev).bfloat16()
        args = (q, k, v, *tabs, kbias, o, lse, do, train_h, scale)
        got = fa.ring_attention_bwd_cuda(*args)
        torch.cuda.synchronize()
        zero = all(not x.any() for x in got)
        what = (f"a chunk of padding (L=17 cp=4 chunk 0 vs 2), o/lse of "
                f"{src_lse} (max lse {lse.max().item():.3e})")
        log(f"[kernels] ring_attention_bwd {what}: dq, dk, dv "
            f"{'all exactly 0' if zero else 'NOT ZERO'} "
            f"{'ok' if zero else 'FAIL'}")
        if not zero:
            raise AssertionError("ring_attention_bwd: a chunk of padding "
                                 "gives a non-zero gradient")
        check_deterministic("ring_attention_bwd", what,
                            lambda: fa.ring_attention_bwd_cuda(*args), got)

    # rows 6–7 with the kv-bias over pre-rotated q/k, as the ring's
    # fallback hands them over: the forward at chunk 4112 of L = 8208 over
    # cp = 2 (serve-cp2, timed); the backward there and at chunk 2064 over
    # cp = 4, the shape train-cp4 gives it (timed)
    for b, h, cp, backward in ((2, serve_h, 2, False), (2, train_h, 2, True),
                               (2, train_h, 4, True)):
        q, k, v, tabs, kbias = ring_inputs(dev, gen, b, h, LONG_L, cp, 0,
                                           cp - 1)
        q = fa.rotate_flat(q, tabs[0], tabs[1], h)
        k = fa.rotate_flat(k, tabs[2], tabs[3], h)
        l = q.shape[1]
        what = (f"B={b} H={h} Lq=Lk={l}, {int((kbias < 0).sum())} padded kv "
                f"rows (cp={cp})")
        name = "long_attention_fwd<bias>"
        got = fa.long_attention_cuda(q, k, v, h, scale, kbias)
        want = fa.long_attention_plain(q, k, v, h, scale, kbias)
        err = check_close(name, what + " o", got[0], want[0], 0.0,
                          LONG_FWD_REL * want[0].float().abs().max().item(),
                          "two bf16 ulps of the largest |o|")
        check_close(name, what + " lse", got[1], want[1], 0.0, LSE_TOL,
                    "fp32 sums in another order")
        errs[name] = max(errs.get(name, 0.0), err)
        qh, kh, vh, mask = (*heads(q, k, v),
                            kbias.bfloat16()[None, None, None, :])
        if not backward:
            ms = cuda_ms(lambda: fa.long_attention_cuda(q, k, v, h, scale,
                                                        kbias),
                         iters=10, warmup=2)
            plain_ms = cuda_ms(lambda: fa.long_attention_plain(
                q, k, v, h, scale, kbias), iters=3, warmup=1)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask), iters=10, warmup=2)
            bms, by = attention_bounds(b, h, l, l, d, backward=False)
            record(name, "long_attention_fwd", 251, ms, plain_ms, lib_ms,
                   bms, by)
            log(f"[kernels] {name} {what}: kernel {ms:.4f} ms, twin "
                f"{plain_ms:.4f} ms, SDPA with mask {lib_ms:.4f} ms, bound "
                f"{bms:.4f} ms ({by})")
            continue
        name = "long_attention_bwd<bias>"
        o, lse = got
        do = torch.randn(o.shape, generator=gen, device=dev).bfloat16()
        args = (q, k, v, o, lse, do, h, scale, kbias)
        got = fa.long_attention_bwd_cuda(*args)
        bwd_check(name, what, got, fa.long_attention_bwd_plain(*args))
        check_deterministic(name, what,
                            lambda: fa.long_attention_bwd_cuda(*args), got)
        del got
        ms = cuda_ms(lambda: fa.long_attention_bwd_cuda(*args), iters=10,
                     warmup=2)
        qh, kh, vh = (t.requires_grad_() for t in (qh, kh, vh))
        oh = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        (doh,) = heads(do)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            oh, (qh, kh, vh), doh, retain_graph=True), iters=10, warmup=2)
        del oh
        bms, by = attention_bounds(b, h, l, l, d, backward=True)
        log(f"[kernels] {name} {what}: kernel {ms:.4f} ms, SDPA backward "
            f"with mask {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        if cp != 4:  # the row: the shape train-cp4 gives it
            continue
        plain_ms = cuda_ms(lambda: fa.long_attention_bwd_plain(*args),
                           iters=2, warmup=1)
        log(f"[kernels] {name} {what}: twin {plain_ms:.4f} ms")
        record(name, "long_attention_bwd", 534, ms, plain_ms, lib_ms, bms, by)
    for name, row in rows.items():
        row["max_abs_err"] = errs[name]
    torch.cuda.empty_cache()
    return rows


def gelu_atol(s, factor, coeffs, fp32: bool):
    """How far two fp32 evaluations of a fitted polynomial may part: four
    fp32 ulps of factor·(0.5 + Σ|c_i|·t^2i), t = min(|s|/R, 1), its largest
    term (the fits cancel terms up to 20·t^8 for Φ, 180·t^8 for Φ', 256·t^8
    for gelu'; the kernels contract their Horner chains into FMAs — Triton
    and nvcc alike — and the CUDA backward evaluates the MLP's Φ + s·Φ' as
    one summed polynomial, the twin does neither). The fp32 A&S form (exp2,
    a division) within 2^-20 of factor·(1 + |s|)."""
    from video_diffusion_speedrun_tpu_torch.ops import fused_gelu as fg

    if fp32:
        return 2.0 ** -20 * factor * (1 + s.abs())
    t2 = (s.abs() / fg._POLY_R).clamp(max=1.0).square()
    terms = sum(abs(c) * t2 ** i for i, c in enumerate(coeffs))
    return 2.0 ** -22 * factor * (0.5 + terms)


def gelu_bwd_bound(shape):
    """Row 16's bound at x [..., F] in bf16 with a bf16 bias: reads x and g
    and the bias, writes dx and dbias; ~40 fp32 flops an element."""
    n = int(np.prod(shape))
    return bound(3 * n * 2 + shape[-1] * 2 * 2, 0, 40 * n)


def hold_gelu_bwd(name, what, x, bias, g, mode):
    """Row 16 on one input against its twin and a second launch: dx within
    one ulp of x's dtype plus the polynomial's term (`gelu_atol`; the MLP's
    variant times 1 + |s|/R, for s·Φ'), dbias within the dx bound and each
    rounding of dx summed over the rows plus 1e-5 (fp32 sums in another
    order); a second launch gives the same bits. Returns the largest error
    of dx and dbias."""
    from video_diffusion_speedrun_tpu_torch.ops import fused_gelu as fg

    fp32 = x.dtype == torch.float32
    coeffs = fg._DPHI_C if mode == fg.BLOCK else fg._DGELU_C
    note = ("2^-20 of the inputs' scale: the kernel's exp2 and division "
            "round otherwise" if fp32 else
            "one ulp of the output + four fp32 ulps of the polynomial's "
            "largest term: nvcc contracts the Horner chains into FMAs and "
            "the MLP's variant sums Φ + s·Φ' into one")

    def run():
        return fg.bias_gelu_backward(x, bias, g, mode)

    dx, db = run()
    rdx, rdb = fg.bias_gelu_bwd_plain(x, bias, g, mode)
    torch.cuda.synchronize()
    s = fg._preact(x, bias, mode)
    ulp = 2.0 ** -20 if fp32 else 2.0 ** -7
    atol = gelu_atol(s, g.float().abs(), coeffs, fp32)
    if mode == fg.BLOCK:  # g·(Φ + hf·Φ'): |hf|/R times Φ''s terms
        atol = atol * (1 + s.abs() / fg._POLY_R)
    del s
    err = check_close(name, what + " dx", dx, rdx, ulp, atol, note)
    if bias is not None:
        col = (atol + ulp * rdx.float().abs()).reshape(-1, x.shape[-1])
        err = max(err, check_close(
            name, what + " dbias", db, rdb, 1e-5, col.sum(0),
            "the dx bound summed over the rows, fp32 sum order"))
    del atol, rdx, rdb
    check_deterministic(name, what, run, (dx, db), ("dx", "dbias"))
    return err


def hold_gelu_bwd_exact(name, dev, gen, shape, bias_dtype):
    """Row 16 (the MLP's variant, bf16 rows) on inputs where every number is
    exact, against its twin bit for bit: |x + bias| ≥ 5, 3 in 4 positive,
    so dg is exactly 0 or 1, and g of integers 1..7, so every dx is exact
    and every fp32 partial sum of dbias an integer below 2^24. A finish
    that drops or repeats a split, a group of splits or a row then moves a
    column of the fp32 dbias by at least 1; a bf16 dbias (the main path's)
    is the same exact sum, rounded once. Returns the largest error (0)."""
    from video_diffusion_speedrun_tpu_torch.ops import fused_gelu as fg

    def rand(*size):
        return torch.rand(*size, generator=gen, device=dev)

    sign = torch.where(rand(*shape) < 0.75, 1.0, -1.0)
    x = (sign * (6.0 + 2.0 * rand(*shape))).bfloat16()
    bias = (2.0 * rand(shape[-1]) - 1.0).to(bias_dtype)
    g = torch.randint(1, 8, shape, generator=gen, device=dev).bfloat16()
    del sign
    dx, db = fg.bias_gelu_backward(x, bias, g, fg.BLOCK)
    rdx, rdb = fg.bias_gelu_bwd_plain(x, bias, g, fg.BLOCK)
    torch.cuda.synchronize()
    what = f"exact {list(shape)} {bias_dtype} bias"
    err = check_close(name, what + " dx", dx, rdx, 0.0, 0.0,
                      "exact: dg is 0 or 1, g an integer")
    err = max(err, check_close(name, what + " dbias", db, rdb, 0.0, 0.0,
                               "exact: integer sums below 2^24"))
    return err


def epilogue_rows(dev):
    """Rows 13–16: the gated-residual AdaLN and bias+GELU kernels against
    their twins at the main path's shapes and ragged ones; times beside the
    twins, the bound and (row 15) `F.gelu`."""
    import torch.nn.functional as F

    from video_diffusion_speedrun_tpu_torch.ops import fused_adaln as fad
    from video_diffusion_speedrun_tpu_torch.ops import fused_gelu as fg

    gen = torch.Generator(device=dev).manual_seed(13)
    rows, errs = {}, {}
    src = "video_diffusion_speedrun_tpu_torch/ops/fused_{}.py"
    rep = "video_diffusion_speedrun_tpu/ops/fused_{}.py:{}"

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    def row(name, module, line, ms, plain_ms, bms, by, lib_ms,
            route="triton", source=None):
        rows[name] = dict(name=name, route=route,
                          source=source or src.format(module),
                          replaces=rep.format(module, line),
                          max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by, library_ms=lib_ms)

    def check(name, what, got, want, rtol, atol, note):
        errs[name] = max(errs.get(name, 0.0),
                         check_close(name, what, got, want, rtol, atol, note))

    # rows 13–14: x, δ [B, L, D]; gate/shift/scale column views of [B, 9D]
    def gr_case(b, l, d, strided):
        x = randn(b, l + 16, d).bfloat16()
        x = x[:, 16:] if strided else x[:, :l].contiguous()
        mod = randn(b, 9 * d).bfloat16()
        return (x, randn(b, l, d).bfloat16(), mod[:, 2 * d:3 * d],
                mod[:, :d], mod[:, d:2 * d])

    fwd, bwd = "gated_residual_adaln_fwd", "gated_residual_adaln_bwd"
    one_ulp = "one bf16 ulp: the same fp32 values, rounded once"
    for b, l, d, with_gamma in ((2, 1040, WIDTH, False),
                                (T_BATCH, T_L, T_WIDTH, True),
                                (2, 333, WIDTH, True), (3, 333, T_WIDTH, False)):
        x, delta, gate, shift, scale = gr_case(b, l, d, strided=l == 333)
        gamma = randn(d) if with_gamma else None
        what = f"[{b}, {l}, {d}] gamma={with_gamma}"
        got = fad.gated_residual_adaln(x, delta, gate, shift, scale, gamma)
        want = fad.gated_residual_adaln_plain(x, delta, gate, shift, scale,
                                              gamma)
        torch.cuda.synchronize()
        check(fwd, what + " x_new", got[0], want[0], 2.0 ** -7, 1e-6,
              one_ulp + " (x + δ·gate, an FMA on one side)")
        check(fwd, what + " y", got[1], want[1], ADALN_RTOL, 1e-2,
              one_ulp + " + 1e-2 (row-sum order), as row 3")
        gx, gy = randn(b, l, d).bfloat16(), randn(b, l, d).bfloat16()

        def run_bwd(gamma=gamma):
            return fad.gated_residual_adaln_bwd(want[0], delta, gate, scale,
                                                gamma, gx, gy)

        got = run_bwd()
        ref = fad.gated_residual_adaln_bwd_plain(want[0], delta, gate, scale,
                                                 gamma, gx, gy)
        torch.cuda.synchronize()
        errs[bwd] = max(errs.get(bwd, 0.0), check_adaln_bwd(
            bwd, what, GR_BWD_NAMES, got, ref, GR_BWD_TOLS))
        check_deterministic(bwd, what, run_bwd, got, GR_BWD_NAMES)
        del got, ref
        if l == 1040:  # the serve shape: time the forward
            n = b * l * d
            ms = cuda_ms(lambda: fad.gated_residual_adaln(x, delta, gate,
                                                          shift, scale))
            plain_ms = cuda_ms(lambda: fad.gated_residual_adaln_plain(
                x, delta, gate, shift, scale), iters=20)
            # reads x, δ and gate/shift/scale, writes x_new and y
            bms, by = bound(4 * n * 2 + 3 * b * d * 2, 0, 8 * n)
            log(f"[kernels] {fwd} [{b}, {l}, {d}]: kernel {ms:.4f} ms, twin "
                f"{plain_ms:.4f} ms, no single library call, bound "
                f"{bms:.4f} ms ({by}), {4 * n * 2 / ms / 1e6:.1f} GB/s")
            fwd_times = (ms, plain_ms, bms, by)
        if l == T_L:  # the train shape: time both, the backward with γ and
            # without (the main path's case), and without γ checked too
            n = b * l * d
            ms = cuda_ms(lambda: fad.gated_residual_adaln(x, delta, gate,
                                                          shift, scale, gamma))
            log(f"[kernels] {fwd} [{b}, {l}, {d}]: kernel {ms:.4f} ms, bound "
                f"{bound(4 * n * 2, 0, 8 * n)[0]:.4f} ms")
            for gm in (gamma, None):
                if gm is None:
                    got = run_bwd(None)
                    ref = fad.gated_residual_adaln_bwd_plain(
                        want[0], delta, gate, scale, None, gx, gy)
                    torch.cuda.synchronize()
                    errs[bwd] = max(errs[bwd], check_adaln_bwd(
                        bwd, f"[{b}, {l}, {d}] gamma=False", GR_BWD_NAMES,
                        got, ref, GR_BWD_TOLS))
                    del got, ref
                ms = cuda_ms(lambda: run_bwd(gm))
                bms, by = adaln_bwd_bound(b, l, d, 2, gm is not None, True)
                log(f"[kernels] {bwd} [{b}, {l}, {d}] gamma={gm is not None}:"
                    f" kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}), "
                    f"{6 * n * 2 / ms / 1e6:.1f} GB/s of rows")
                if gm is None:
                    plain_ms = cuda_ms(
                        lambda: fad.gated_residual_adaln_bwd_plain(
                            want[0], delta, gate, scale, gm, gx, gy), iters=10)
                    log(f"[kernels] {bwd} [{b}, {l}, {d}] gamma=False: twin "
                        f"{plain_ms:.4f} ms, no single library call")
                    rows[bwd] = dict(
                        name=bwd, route="cuda",
                        source="video_diffusion_speedrun_tpu_torch/csrc/"
                               "adaln_bwd.cu",
                        replaces=rep.format("adaln", 379), ms=ms,
                        plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                        library_ms=None)
    row(fwd, "adaln", 281, *fwd_times, None)
    rows[bwd]["max_abs_err"] = errs[bwd]

    # rows 15–16: the MLP's variant at its shapes, bias_gelu on both dtypes
    mlp, fwd, bwd = fg.BLOCK, "bias_gelu_fwd", "bias_gelu_bwd"
    coeffs = {fg.BLOCK: fg._PHI_C, fg.POLY: fg._PHI_C, fg.ERF: ()}
    poly_note = ("one ulp of the output + four fp32 ulps of the polynomial's "
                 "largest term: the kernels contract the Horner chains into "
                 "FMAs (the backward's MLP variant sums Φ + s·Φ' into one)")
    erf_note = ("2^-20 of the inputs' scale: the kernels' exp2 and division "
                "round otherwise")
    cases = [(mlp, (2, 1040, MLP), True), (mlp, (2, LONG_L, MLP), True),
             (mlp, (T_BATCH, T_L, T_MLP), True),
             (mlp, (2, LONG_L, T_MLP), True), (mlp, (3, 333, 320), True)]
    # the training shape at the tensor-parallel local columns F/t
    cases += [(mlp, (T_BATCH, T_L, T_MLP // t), True) for t in TP_WAYS]
    # the XL in-backward step's MLP (train-inloop); a width the backward's
    # bulk copies refuse (200-byte rows: its masked loads)
    cases += [(mlp, XL_GELU, True), (mlp, (3, 77, 100), True)]
    cases += [(mode, (2, 333, T_MLP), with_bias)
              for mode in (fg.POLY, fg.ERF) for with_bias in (True, False)]
    for mode, shape, with_bias in cases:
        fp32 = mode == fg.ERF
        x = randn(*shape, std=3.0).to(torch.float32 if fp32 else
                                      torch.bfloat16)
        bias = randn(shape[-1], std=0.5).to(x.dtype) if with_bias else None
        what = (f"{('mlp', 'poly', 'erf')[mode]} {list(shape)} "
                f"{x.dtype} bias={with_bias}")
        s = fg._preact(x, bias, mode)
        ulp = 2.0 ** -20 if fp32 else 2.0 ** -7
        y = fg.bias_gelu_forward(x, bias, mode)
        want = fg.bias_gelu_fwd_plain(x, bias, mode)
        torch.cuda.synchronize()
        note = erf_note if fp32 else poly_note
        check(fwd, what, y, want, ulp,
              gelu_atol(s, s.abs(), coeffs[mode], fp32), note)
        del y, want
        serve = shape in ((2, LONG_L, MLP), (2, 1040, MLP))
        if not serve:  # the backward at the training shapes and the rest
            g = randn(*shape).to(x.dtype)
            errs[bwd] = max(errs.get(bwd, 0.0),
                            hold_gelu_bwd(bwd, what, x, bias, g, mode))
            del g
        if shape == (2, LONG_L, MLP):  # time the forward at the CLI default
            n = x.numel()
            ms = cuda_ms(lambda: fg.bias_gelu_forward(x, bias, mode),
                         iters=20)
            plain_ms = cuda_ms(lambda: fg.bias_gelu_fwd_plain(x, bias, mode),
                               iters=3, warmup=1)
            pre = (x + bias).contiguous()
            lib_ms = cuda_ms(lambda: F.gelu(pre), iters=20)
            del pre
            # reads x, writes y; ~20 fp32 flops an element
            bms, by = bound(2 * n * 2 + shape[-1] * 2, 0, 20 * n)
            log(f"[kernels] {fwd} {what}: kernel {ms:.4f} ms, twin "
                f"{plain_ms:.4f} ms, F.gelu on x + bias {lib_ms:.4f} ms, "
                f"bound {bms:.4f} ms ({by}), {2 * n * 2 / ms / 1e6:.1f} GB/s")
            row(fwd, "gelu", 157, ms, plain_ms, bms, by, lib_ms)
        elif mode == mlp and shape[1] in (T_L, LONG_L, XL_L):
            n = x.numel()
            ms = cuda_ms(lambda: fg.bias_gelu_forward(x, bias, mode))
            log(f"[kernels] {fwd} {what}: kernel {ms:.4f} ms, bound "
                f"{bound(2 * n * 2, 0, 20 * n)[0]:.4f} ms")
            if not serve:
                g = randn(*shape).to(x.dtype)
                ms = cuda_ms(lambda: fg.bias_gelu_backward(x, bias, g, mode))
                bms, by = gelu_bwd_bound(shape)
                log(f"[kernels] {bwd} {what}: kernel {ms:.4f} ms, bound "
                    f"{bms:.4f} ms ({by}), {3 * n * 2 / ms / 1e6:.1f} GB/s")
                if shape == (T_BATCH, T_L, T_MLP):
                    plain_ms = cuda_ms(lambda: fg.bias_gelu_bwd_plain(
                        x, bias, g, mode), iters=5, warmup=1)
                    log(f"[kernels] {bwd} {what}: twin {plain_ms:.4f} ms")
                    row(bwd, "gelu", 184, ms, plain_ms, bms, by, None,
                        route="cuda", source="video_diffusion_speedrun_tpu_"
                                             "torch/csrc/bias_gelu_bwd.cu")
                del g
        del x, s

    # the MLP's variant where Φ saturates: y = x or 0, dx = g or 0
    x = torch.tensor([4.5, -4.5, 64.0, -64.0, 1e4, -1e4], device=dev)
    x = x.repeat(2, 7, 48).bfloat16()  # [2, 7, 288]
    bias = torch.zeros(x.shape[-1], device=dev).bfloat16()
    pos = (x > 0).float()
    y = fg.bias_gelu_forward(x, bias, mlp)
    dx, db = fg.bias_gelu_backward(x, bias, torch.ones_like(x), mlp)
    torch.cuda.synchronize()
    check(fwd, "mlp saturated tails y", y, x.float() * pos, 0.0, 0.0,
          "exactly x or 0")
    check(bwd, "mlp saturated tails dx", dx, pos, 0.0, 0.0, "exactly 1 or 0")
    check(bwd, "mlp saturated tails dbias", db, pos.sum((0, 1)), 0.0, 0.0,
          "exactly the count of positive rows")
    # s = ±∞: dx and dbias NaN in those columns, as the twin's s·Φ'(s)
    x = torch.tensor([float("inf"), -float("inf"), 4.5, -4.5], device=dev)
    x = x.repeat(2, 7, 8).bfloat16()  # [2, 7, 32]
    bias = torch.zeros(x.shape[-1], device=dev).bfloat16()
    dx, db = fg.bias_gelu_backward(x, bias, torch.ones_like(x), mlp)
    rdx, rdb = fg.bias_gelu_bwd_plain(x, bias, torch.ones_like(x), mlp)
    torch.cuda.synchronize()
    inf = x.float().isinf()
    nan_ok = (torch.equal(dx.isnan(), inf) and torch.equal(rdx.isnan(), inf)
              and torch.equal(db.isnan(), inf[0, 0])
              and torch.equal(rdb.isnan(), inf[0, 0]))
    log(f"[kernels] {bwd} mlp s = ±inf: dx and dbias NaN where the twin's "
        f"are {'ok' if nan_ok else 'FAIL'}")
    if not nan_ok:
        raise AssertionError(f"{bwd} keeps no NaN at s = ±inf")
    check(bwd, "mlp s = ±inf, finite dx", dx[~inf], rdx[~inf], 0.0, 0.0,
          "exactly 1 or 0")
    check(bwd, "mlp s = ±inf, finite dbias", db[~inf[0, 0]],
          rdb[~inf[0, 0]], 0.0, 0.0, "exactly the count of positive rows")
    # integer sums at the main path's shapes: every split and group counts
    for shape in ((T_BATCH, T_L, T_MLP), (T_BATCH, T_L, T_MLP // 4),
                  XL_GELU):
        for bias_dtype in (torch.float32, torch.bfloat16):
            errs[bwd] = max(errs[bwd], hold_gelu_bwd_exact(
                bwd, dev, gen, shape, bias_dtype))
            torch.cuda.empty_cache()
    rows[bwd]["max_abs_err"] = errs[bwd]
    torch.cuda.empty_cache()
    return rows


def randomize_zero_layers(model, gen) -> None:
    """Give the zero-initialised AdaLN and output layers random weights: at
    the zero init the DiT outputs exactly 0 and sampling never moves the
    latents, which would hide any kernel fault. Biases of 0.3 make the
    gates, shifts and scales O(1), so every sub-layer shapes the output."""
    with torch.no_grad():
        lins = [blk.adaLN_modulation[1] for blk in model.blocks]
        lins += [model.final_modulation[1], model.final_proj]
        for lin in lins:
            dev = lin.weight.device
            w = torch.randn(lin.weight.shape, generator=gen, device=dev)
            lin.weight.copy_(w * 0.02)
            bias_std = 0.0 if lin is model.final_proj else 0.3
            b = torch.randn(lin.bias.shape, generator=gen, device=dev)
            lin.bias.copy_(b * bias_std)


def counters():
    """Kernel name → (wrapper, attribute) whose count is its launches; the
    long kernels count their kv-bias launches (the ring's fallback) apart."""
    from video_diffusion_speedrun_tpu_torch.ops import fused_adamw as fw
    from video_diffusion_speedrun_tpu_torch.ops import fused_adaln as fad
    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa
    from video_diffusion_speedrun_tpu_torch.ops import fused_gelu as fg
    from video_diffusion_speedrun_tpu_torch.ops import fused_mmdit as fm

    fns = {"short_attention_fwd<rope>": fa.qkv_rope_flash_forward,
           "short_attention_fwd<norope>": fa.cross_flash_forward,
           "adaln_rms_modulate_fwd": fad.adaln_rms_modulate,
           "short_attention_bwd<rope>": fa.qkv_rope_flash_backward,
           "short_attention_bwd<norope>": fa.cross_flash_backward,
           "adaln_rms_modulate_bwd": fad.adaln_rms_modulate_bwd,
           "adamw_multi_tensor": fw.MultiTensorAdamW,
           "factored_adamw": fw.FactoredAdamW,
           "long_attention_fwd": fa.long_attention_forward,
           "long_attention_bwd": fa.long_attention_backward,
           "gated_residual_adaln_fwd": fad.gated_residual_adaln,
           "gated_residual_adaln_bwd": fad.gated_residual_adaln_bwd,
           "bias_gelu_fwd": fg.bias_gelu_forward,
           "bias_gelu_bwd": fg.bias_gelu_backward,
           "ring_attention_fwd": fa.ring_chunk_forward,
           "ring_attention_bwd": fa.ring_chunk_backward,
           "qk_norm_rope": fm.qk_norm_rope,
           "ln_modulate": fm.ln_modulate,
           "gelu_tanh": fm.gelu_tanh}
    out = {name: (fn, "launches") for name, fn in fns.items()}
    out["long_attention_fwd<bias>"] = (fa.long_attention_forward,
                                       "bias_launches")
    out["long_attention_bwd<bias>"] = (fa.long_attention_backward,
                                       "bias_launches")
    # row 17 on bf16 parameters (the optimizer-in-backward XL regime)
    out["adamw_multi_tensor<bf16>"] = (fw.MultiTensorAdamW, "bf16_launches")
    return out


# rows 8–9 are functions of the row 6/7 launches: their counts are those
COUNTED_AS = {"long_attention_fwd<split>": "long_attention_fwd",
              "long_attention_bwd<split>": "long_attention_bwd"}


def reset_counters() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counters():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in counters().items()}


def build_demo(dev, **overrides):
    """The demo DiT (random weights, the zero-initialised layers made
    random) in bf16 on the card, and a seeded 512×4096 context."""
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT
    from video_diffusion_speedrun_tpu_torch.sample import demo_config

    cfg = demo_config(WIDTH, DEPTH, HEAD_DIM, CTX_DIM,
                      param_dtype=torch.bfloat16, **overrides)
    t0 = time.perf_counter()
    model = DiT(cfg, device=dev, init_std_factor=0.1, seed=0)
    randomize_zero_layers(model, torch.Generator(device=dev).manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"[serve] demo DiT {n_params / 1e9:.3f} B params (bf16) built in "
        f"{time.perf_counter() - t0:.1f} s; {overrides or 'default config'}")
    gen = torch.Generator(device=dev).manual_seed(1)
    context = torch.randn(1, CTX_LEN, CTX_DIM, generator=gen,
                          device=dev).bfloat16() * 0.05
    return model, context


def phase_serve(dev, model, context, px: int, frames: int, steps: int,
                seeds, tag: str, ring=None):
    """Sample one request per seed through `generate_latents` (over `ring`
    if given) with the launch counters set to 0 just before and read just
    after; check the counts per Euler step and the latents; profile one
    Euler step. Returns the counts and the latents."""
    from video_diffusion_speedrun_tpu_torch.core.config import SamplingConfig
    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa
    from video_diffusion_speedrun_tpu_torch.sampling.euler import (
        generate_latents,
    )

    l = (frames // 2) * (px // 16) ** 2 + 16
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    outs, step_ms = [], []
    for seed in seeds:
        sampling = SamplingConfig(inference_steps=steps, cfg_scale=6.0,
                                  height=px, width=px,
                                  num_latent_frames=frames, seed=seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = generate_latents(model, context, sampling,
                               context_parallel=ring)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0) / steps)
        outs.append(lat)
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    # sampling runs no backward and no optimizer; self-attention takes the
    # short kernel up to SHORT_MAX_KV tokens and the long one past it, or
    # over a ring cp² chunk forwards (row 10 up to its 4096 kv rows, the
    # long kernel with the kv-bias above); with fused_residual the norms
    # after self- and cross-attention run in the two gated-residual joins
    # of each block
    if ring is None:
        self_attn, per_layer = ("short_attention_fwd<rope>"
                                if l <= fa.SHORT_MAX_KV
                                else "long_attention_fwd"), 1
    else:
        chunk, _ = fa.ring_layout(l, ring.size)
        self_attn = ("ring_attention_fwd" if chunk <= fa._RING_FULLK_MAX_FWD
                     else "long_attention_fwd<bias>")
        per_layer = ring.size ** 2
    fused_residual = model.cfg.fused_residual
    n = len(seeds) * steps
    want = dict.fromkeys(launches, 0)
    want.update({self_attn: n * DEPTH * per_layer,
                 "short_attention_fwd<norope>": n * DEPTH,
                 "adaln_rms_modulate_fwd": n * (
                     DEPTH + 1 if fused_residual else ADALN_PER_FORWARD),
                 "gated_residual_adaln_fwd": n * 2 * DEPTH * fused_residual,
                 "bias_gelu_fwd": n * DEPTH})
    where = "" if ring is None else (
        f", tokens over LocalRing({ring.size}): every rank's work on this "
        f"one card")
    for i, (seed, lat, ms) in enumerate(zip(seeds, outs, step_ms)):
        log(f"[{tag}] request {i} seed {seed}: latents {tuple(lat.shape)} "
            f"std {lat.std().item():.4f}, {ms:.2f} ms per Euler step "
            f"(one forward at batch 2, L={l}{where})")
    log(f"[{tag}] peak memory {peak_gb:.2f} GB; launches {launches}, "
        f"expected {want}")
    expect_shape = (1, 16, frames, px // 8, px // 8)
    for lat in outs:
        if tuple(lat.shape) != expect_shape or not bool(torch.isfinite(lat).all()):
            raise AssertionError(f"bad latents {tuple(lat.shape)}")
    # the sampler moved the noise, and two requests differ
    for seed, lat in zip(seeds, outs):
        g = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.randn(lat.shape, generator=g, device=dev).bfloat16()
        moved = (lat - noise.float()).norm() / noise.float().norm()
        log(f"[{tag}] seed {seed}: |latents − noise| / |noise| = "
            f"{moved.item():.4f}")
        if not moved.item() > 1e-2:
            raise AssertionError("sampling did not move the latents")
    if len(outs) > 1 and torch.equal(outs[0], outs[1]):
        raise AssertionError("two seeds gave the same latents")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    profile_step(model, context, outs[-1], tag + "-profile", ring)
    return launches, outs


def profile_step(model, context, lat, tag: str, ring=None):
    """Device time by kernel over one Euler step (one batch-2 forward)."""
    ckv = model.precompute_context_kv(torch.cat([context,
                                                 torch.zeros_like(context)]))
    x2 = torch.cat([lat, lat]).bfloat16()
    t2 = torch.full((2,), 0.5, device=lat.device)
    with torch.no_grad():
        model(x2, None, t2, context_kv=ckv, context_parallel=ring)
        profile_device(lambda: model(x2, None, t2, context_kv=ckv,
                                     context_parallel=ring),
                       "one forward", tag)


# profile rows grouped by kernel name: (kind, substrings), first match wins
KERNEL_KINDS = (
    ("AdaLN backward kernel (csrc/adaln_bwd.cu)", ("adaln_bwd_kernel",)),
    ("bias+GELU kernels (Triton forward, csrc/bias_gelu_bwd.cu)",
     ("bias_gelu",)),
    ("attention kernels (csrc/attention_{fwd,bwd}.cuh)",
     ("short_attention", "long_attention", "fwd_kernel", "bwd_kernel",
      "dq_store", "dkv_reduce", "prep_q", "prep_k", "rope_rotate")),
    ("AdaLN forward kernels (Triton)", ("adaln_rms_modulate",)),
    ("gated-residual AdaLN forward kernels (Triton)",
     ("gated_residual_adaln",)),
    ("AdamW kernel (csrc/adamw_multi_tensor.cu)", ("adamw_multi_tensor",)),
    ("factored-ν AdamW kernel (csrc/factored_adamw.cu)", ("factored_adamw",)),
    ("convolutions (cuDNN)", ("fprop", "implicit_convolve", "conv3d",
                              "convolve_sgemm", "winograd")),
    ("GEMMs (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
    ("PyTorch elementwise, reductions and copies", ("at::native",)),
)


def profile_device(fn, what: str, tag: str, rows: int = 14):
    """Run `fn` once under torch.profiler and print the device busy time
    and the kernels with the most device time. Returns (wall ms, busy ms,
    busy ms by kind), or None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # kernel rows only: an operator's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        log(f"[{tag}] the profiler saw no device time: not measured")
        return None
    log(f"[{tag}] {what}: {wall_ms:.2f} ms wall (profiled), device "
        f"busy {total_ms:.2f} ms ({100 * total_ms / wall_ms:.1f}% of wall)")
    for e in events[:rows]:
        ms = e.self_device_time_total / 1e3
        log(f"[{tag}]   {ms:8.3f} ms {100 * ms / total_ms:5.1f}% "
            f"x{e.count:<4d} {e.key[:90]}")
    by_kind = {}
    for e in events:
        kind = next((k for k, keys in KERNEL_KINDS if any(
            s in e.key for s in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"[{tag}] by kind: {ms:8.3f} ms {100 * ms / total_ms:5.1f}% "
            f"{kind}")
    return wall_ms, total_ms, by_kind


def phase_parity(dev, frames: int, tag: str, cp: int = 0, **overrides):
    """Depth 2, full width: 2 Euler steps on the card (bf16, kernels)
    against the CPU (fp32, the fused ops' twins), same weights and noise,
    at 256×256 with `frames` latent frames, over `LocalRing(cp)` on both
    sides if cp; `overrides` of the config on both sides."""
    from video_diffusion_speedrun_tpu_torch.parallel.ring import LocalRing

    from video_diffusion_speedrun_tpu_torch.sample import demo_config
    from video_diffusion_speedrun_tpu_torch.sampling.euler import (
        euler_cfg_sample,
    )
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT

    cpu_cfg = demo_config(WIDTH, 2, HEAD_DIM, CTX_DIM,
                          compute_dtype=torch.float32,
                          attention_impl="fused", fused_adaln="fused",
                          **overrides)
    cpu_model = DiT(cpu_cfg, device="cpu", init_std_factor=0.1, seed=0)
    randomize_zero_layers(cpu_model, torch.Generator().manual_seed(1))
    card_model = DiT(demo_config(WIDTH, 2, HEAD_DIM, CTX_DIM,
                                 param_dtype=torch.bfloat16, **overrides),
                     device=dev)
    card_model.load_state_dict(cpu_model.state_dict())

    rng = np.random.default_rng(0)
    shape = (1, 16, frames, HEIGHT // 8, WIDTH_PX // 8)
    l = (frames // 2) * (HEIGHT // 16) * (WIDTH_PX // 16) + 16
    noise = torch.from_numpy(rng.standard_normal(shape, np.float32)).bfloat16()
    ctx = torch.from_numpy(
        rng.standard_normal((1, CTX_LEN, CTX_DIM), np.float32) * 0.05)
    ring = LocalRing(cp) if cp else None
    t0 = time.perf_counter()
    cpu = euler_cfg_sample(cpu_model, noise.float(), ctx, num_steps=2,
                           cfg_scale=6.0, context_parallel=ring)
    cpu_s = time.perf_counter() - t0
    card = euler_cfg_sample(card_model, noise.to(dev), ctx.to(dev).bfloat16(),
                            num_steps=2, cfg_scale=6.0,
                            context_parallel=ring).cpu()
    d_cpu, d_card = cpu - noise.float(), card - noise.float()
    rel = ((d_card - d_cpu).norm() / d_cpu.norm()).item()
    ok = rel <= PARITY_REL_L2 and bool(torch.isfinite(card).all())
    log(f"[{tag}] depth 2, width {WIDTH}, L={l}"
        f"{f', LocalRing({cp})' if cp else ''}, 2 steps: relative L2 of the "
        f"latent update, card vs CPU {rel:.3e} (tol {PARITY_REL_L2}; CPU "
        f"run {cpu_s:.1f} s) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("card and CPU disagree")


def train_config(depth: int, width: int = T_WIDTH, **overrides):
    """The canonical training DiT, built as the training CLI builds it."""
    from video_diffusion_speedrun_tpu_torch.train.__main__ import (
        build_config,
        parse_args,
    )

    cfg = build_config(parse_args(train_argv(depth, width=width)))
    return cfg.model.replace(**overrides)


def train_argv(depth: int, width: int = T_WIDTH, batch: int = T_BATCH,
               extra=()):
    """The JAX package's canonical speedrun flags (train.py docstring)."""
    return ["--batch_size", str(batch), "--learning_rate", str(T_LR),
            "--max_steps", "5004", "--evaluate_every", "500",
            "--model_width", str(width), "--model_depth", str(depth),
            "--model_head_dim", str(T_HEAD_DIM),
            "--lr_scheduler_type", "linear", *extra]


def latent_len(latent) -> int:
    """Tokens of a [C, T, H, W] latent (T floor-cropped to even) plus the
    16 registers."""
    _, t, hh, ww = latent
    return (t // 2) * (hh // 2) * (ww // 2) + 16


def first_step(trainer, cfg, ring=None, memory=None):
    """The loss on the Trainer's first batch with the draws of the first
    timed step (a generator seeded as `phase_train`'s) and its gradient,
    name → fp32 tensor on the host; the model's gradients are left unset.
    A `memory` dict gets the GB allocated before the forward, when the
    backward starts (what the forward keeps for it) and the peak of the
    two."""
    from video_diffusion_speedrun_tpu_torch.train.step import _loss

    gen = torch.Generator(device=trainer.device).manual_seed(cfg.seed + 1)
    batch = next(trainer.batches("train"))
    if memory is not None:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(trainer.device)
        memory["held"] = torch.cuda.memory_allocated(trainer.device) / 1e9
    loss, _ = _loss(trainer.model, batch, gen, cfg, ring)
    if memory is not None:
        memory["backward start"] = (
            torch.cuda.memory_allocated(trainer.device) / 1e9)
    loss.backward()
    if memory is not None:
        memory["forward+backward peak"] = (
            torch.cuda.max_memory_allocated(trainer.device) / 1e9)
    grads = {name: p.grad.float().cpu()
             for name, p in trainer.model.named_parameters()
             if p.grad is not None}
    trainer.model.zero_grad(set_to_none=True)
    return loss.item(), grads


def grad_rel_l2(grads, ref):
    """The whole gradient's relative L2 against `ref`, and the worst
    tensor's (name, relative L2). A tensor's error is held against the
    larger of its own norm and 1e-4 of the whole gradient's: the whole
    norm is dominated by the output and modulation layers, so a fault in
    the attention's gradients hides in it, and a tensor with next to no
    gradient would turn rounding noise into a large ratio."""
    if grads.keys() != ref.keys():
        raise AssertionError(f"gradients of other parameters: "
                             f"{sorted(grads.keys() ^ ref.keys())}")
    whole = torch.stack([r.norm() for r in ref.values()]).norm()
    diff = {n: (grads[n] - r).norm() for n, r in ref.items()}
    rel = (torch.stack(list(diff.values())).norm() / whole).item()
    worst = max(ref, key=lambda n: diff[n] / max(ref[n].norm(), 1e-4 * whole))
    return rel, (worst, (diff[worst] / max(ref[worst].norm(), 1e-4 * whole))
                 .item())


def train_step_launches(l: int, fused_residual: bool = False, ring=None,
                        depth: int = T_DEPTH, adamw: int = 1,
                        bf16_params: bool = False,
                        kept_attention: bool = False, factored: int = 0):
    """Kernel → launches of one train step of a DiT of `depth` blocks (the
    canonical one by default) at L. The AdamW kernel runs `adamw` times a
    step: once, or once per group of the optimizer-in-backward step
    (depth + 1), where the factored-ν kernel launches `factored` times (2
    a block group with factored weights), and whose forward without grad
    and recompute launch what the
    standard step's forward and remat recompute do. With `kept_attention`
    (the remat policies "attn" and "dots_attn") the recompute replays the
    attention forwards' outputs: they launch once a block, not twice."""
    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa

    short = l <= fa.SHORT_MAX_KV
    # AdaLN norms per block: 3, or only norm1 beside 2 gated-residual joins
    norms, joins = (1, 2) if fused_residual else (3, 0)
    # self-attention: the short or long kernels, or over a ring cp² chunk
    # calls a layer, each kernel up to its ceiling (forward 4096, backward
    # 2048 kv rows) and the long kernel with the kv-bias above
    fwd_k, bwd_k, per_layer = ("short_attention_fwd<rope>" if short
                               else "long_attention_fwd",
                               "short_attention_bwd<rope>" if short
                               else "long_attention_bwd", 1)
    if ring is not None:
        chunk, _ = fa.ring_layout(l, ring.size)
        fwd_k = ("ring_attention_fwd" if chunk <= fa._RING_FULLK_MAX_FWD
                 else "long_attention_fwd<bias>")
        bwd_k = ("ring_attention_bwd" if chunk <= fa._RING_FULLK_MAX_BWD
                 else "long_attention_bwd<bias>")
        per_layer = ring.size ** 2
    per_step = dict.fromkeys(counters(), 0)
    attn_runs = 1 if kept_attention else 2
    per_step.update({
        # forward + remat recompute; the final layer's AdaLN runs once
        fwd_k: attn_runs * depth * per_layer,
        "short_attention_fwd<norope>": attn_runs * depth,
        "adaln_rms_modulate_fwd": 2 * norms * depth + 1,
        "gated_residual_adaln_fwd": 2 * joins * depth,
        "bias_gelu_fwd": 2 * depth,
        bwd_k: depth * per_layer,
        "short_attention_bwd<norope>": depth,
        "adaln_rms_modulate_bwd": norms * depth + 1,
        "gated_residual_adaln_bwd": joins * depth,
        "bias_gelu_bwd": depth,
        "adamw_multi_tensor": adamw,
        "adamw_multi_tensor<bf16>": adamw if bf16_params else 0,
        "factored_adamw": factored})
    return per_step


class TimedEncoder:
    """A prompt encoder whose calls are timed between synchronisations
    (the T5 ms of each train step's batch)."""

    def __init__(self, encoder):
        self.encoder, self.ms = encoder, []

    def __call__(self, prompts, return_index: int = -1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.encoder(prompts, return_index=return_index)
        torch.cuda.synchronize()
        self.ms.append(1e3 * (time.perf_counter() - t0))
        return out


def phase_train(dev, batch: int, latent, steps: int, extra, tag: str,
                evaluate: bool, ring=None, probe: bool = False,
                prompt_encoder=None, **overrides):
    """The canonical DiT (its config with `overrides`) through the port's
    Trainer (over `ring` if given): `steps` timed steps of `train_step`
    with the launch counters set to 0 just before and read just after,
    optionally one evaluation, one profiled step. With `probe` the
    zero-initialised layers are made random, so that the loss and every
    gradient go through attention, and the first step's gradients are
    taken before the timed steps (`first_step`). With a
    `prompt_encoder` (a `TimedEncoder`) the context of each batch is the
    T5 encoding of its captions, timed apart from the step. Returns the
    counts, the losses, those gradients (None without `probe`) and the
    steady ms per step."""
    from video_diffusion_speedrun_tpu_torch.train.__main__ import (
        build_config,
        parse_args,
    )
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer
    from video_diffusion_speedrun_tpu_torch.train.step import train_step
    from video_diffusion_speedrun_tpu_torch.utils.flops import (
        dit_train_flops,
        mfu,
    )

    cfg = build_config(parse_args(train_argv(T_DEPTH, batch=batch,
                                             extra=extra)))
    cfg = dataclasses.replace(cfg, model=cfg.model.replace(**overrides),
                              data=dataclasses.replace(
                                  cfg.data, synthetic_shape=tuple(latent)))
    l = latent_len(latent)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev, context_parallel=ring,
                      prompt_encoder=prompt_encoder)
    if probe:
        randomize_zero_layers(trainer.model,
                              torch.Generator(device=dev).manual_seed(1))
    n_leaves = len(trainer.opt.params)
    torch.cuda.synchronize()
    moments = cfg.optimizer.moments_dtype or "fp32"
    log(f"[{tag}] canonical DiT: {trainer.n_params / 1e6:.2f} M params in "
        f"{n_leaves} leaves, built in {time.perf_counter() - t0:.1f} s; "
        f"batch {batch}, latent {tuple(latent)} → L={l}, remat "
        f"{cfg.model.remat}, moments {moments}, lr {T_LR}, "
        f"{cfg.optimizer.scheduler} schedule; {overrides or 'default config'}"
        + ("; zero-initialised layers made random" if probe else "")
        + ("" if ring is None else f"; tokens over LocalRing({ring.size}), "
           "every rank's work on this one card"))
    grads = first_step(trainer, cfg, ring)[1] if probe else None
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    loader = trainer.batches("train")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    losses, step_ms = [], []
    for step in range(steps):
        batch_t = next(loader)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(trainer.model, trainer.opt, batch_t, gen, cfg, ring)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        t5 = "" if prompt_encoder is None else (
            f"; T5 encode of its {batch} captions × 512 tokens "
            f"{prompt_encoder.ms[-1]:.2f} ms before it")
        log(f"[{tag}] step {step}: loss {losses[-1]:.5f}, lr scale "
            f"{m['lr_scale']:.4f}, {step_ms[-1]:.2f} ms{t5}")
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    per_step = train_step_launches(l, cfg.model.fused_residual, ring,
                                   depth=cfg.model.depth)
    want = {k: steps * v for k, v in per_step.items()}
    skip = 2 if steps >= 6 else 1  # warm-up steps (cuBLAS, Triton, caches)
    steady = float(np.median(step_ms[skip:]))
    flops = dit_train_flops(cfg.model, batch, *latent[1:])
    log(f"[{tag}] steady state {steady:.2f} ms per step (median of steps "
        f"{skip}–{steps - 1}), {flops / 1e12:.2f} useful TFLOP "
        f"per step → MFU "
        f"{mfu(flops, steady / 1e3, torch.cuda.get_device_name(0)):.4f} of "
        f"one card; peak memory {peak_gb:.2f} GB")
    if prompt_encoder is not None:
        t5_ms = float(np.median(prompt_encoder.ms[skip:steps]))
        log(f"[{tag}] T5-XXL encode {t5_ms:.2f} ms per step (median of "
            f"steps {skip}–{steps - 1}; {T_BATCH} captions × 512 tokens, "
            f"re-encoded every step as the reference does) beside "
            f"{steady:.2f} ms of train step: "
            f"{100 * t5_ms / (t5_ms + steady):.1f}% of the two")
    log(f"[{tag}] launches {launches}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss {losses}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if evaluate:
        ev = trainer.evaluate()
        log(f"[{tag}] evaluate: test loss {ev['test/total_loss']:.5f}")
        if not np.isfinite(ev["test/total_loss"]):
            raise AssertionError("non-finite evaluation loss")
    batch_t = next(loader)
    profile_device(lambda: train_step(trainer.model, trainer.opt, batch_t,
                                      gen, cfg, ring), "one train step",
                   tag + "-profile", rows=16)
    del trainer, loader
    torch.cuda.empty_cache()
    return launches, losses, grads, steady


def phase_train_parity(dev, width: int, latent, b: int, tag: str,
                       cp: int = 0, **overrides):
    """Depth 2: 3 steps on the card (bf16 compute, kernels) against the
    CPU (fp32, twins), same weights and injected batches, over
    `LocalRing(cp)` on both sides if cp; `overrides` of the config on both
    sides."""
    from video_diffusion_speedrun_tpu_torch.parallel.ring import LocalRing

    from video_diffusion_speedrun_tpu_torch.core.config import (
        OptimizerConfig,
        TrainConfig,
    )
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT
    from video_diffusion_speedrun_tpu_torch.train.loss import (
        rectified_flow_loss,
    )
    from video_diffusion_speedrun_tpu_torch.train.optim import MupAdamW
    from video_diffusion_speedrun_tpu_torch.train.step import train_step

    steps = 3
    cpu_mcfg = train_config(2, width, compute_dtype=torch.float32,
                            attention_impl="fused", fused_adaln="fused",
                            **overrides)
    cpu_model = DiT(cpu_mcfg, device="cpu", init_std_factor=0.1, seed=0)
    randomize_zero_layers(cpu_model, torch.Generator().manual_seed(1))
    card_model = DiT(train_config(2, width, **overrides), device=dev)
    card_model.load_state_dict(cpu_model.state_dict())

    rng = np.random.default_rng(0)
    c, t, hh, ww = latent
    data = [dict(
        latent=rng.standard_normal((b, c, t, hh, ww), np.float32),
        context=rng.standard_normal((b, CTX_LEN, CTX_DIM), np.float32) * 0.05,
        timesteps=rng.uniform(0.02, 0.98, b).astype(np.float32),
        noise=rng.standard_normal((b, c, t // 2 * 2, hh, ww), np.float32),
        rope_offsets=rng.integers(0, 100, 3)) for _ in range(steps)]

    ring = LocalRing(cp) if cp else None

    def run(model, device):
        opt_cfg = OptimizerConfig(learning_rate=T_LR, scheduler="linear",
                                  warmup_steps=0)
        cfg = TrainConfig(model=model.cfg, batch_size=b, max_steps=steps,
                          caption_dropout=0.0, optimizer=opt_cfg)
        batches = [{k: torch.from_numpy(np.asarray(v)).to(device)
                    for k, v in bt.items()} for bt in data]
        first = batches[0]
        loss, _ = rectified_flow_loss(
            model, first["latent"], first["context"], None,
            caption_dropout=0.0, timesteps=first["timesteps"],
            noise=first["noise"], rope_offsets=first["rope_offsets"],
            context_parallel=ring)
        loss.backward()
        grads = torch.cat([p.grad.float().flatten().cpu()
                           for p in model.parameters() if p.grad is not None])
        model.zero_grad(set_to_none=True)
        opt = MupAdamW(model.named_parameters(), T_LR, steps, opt_cfg)
        losses = [float(train_step(model, opt, bt, None, cfg, ring)["loss"])
                  for bt in batches]
        return losses, grads

    t0 = time.perf_counter()
    cpu_losses, cpu_grads = run(cpu_model, "cpu")
    cpu_s = time.perf_counter() - t0
    card_losses, card_grads = run(card_model, dev)
    loss_rel = [abs(a / w - 1) for a, w in zip(card_losses, cpu_losses)]
    grad_rel = ((card_grads - cpu_grads).norm() / cpu_grads.norm()).item()
    log(f"[{tag}] depth 2, width {width}, batch {b}, latent {tuple(latent)} "
        f"→ L={latent_len(latent)}{f', LocalRing({cp})' if cp else ''}, "
        f"3 steps: losses card {card_losses} vs "
        f"CPU {cpu_losses} (CPU run {cpu_s:.1f} s); relative loss difference "
        f"{max(loss_rel):.3e} (tol {TRAIN_LOSS_REL}); step-1 gradient "
        f"relative L2 {grad_rel:.3e} (tol {TRAIN_GRAD_REL_L2})")
    if max(loss_rel) > TRAIN_LOSS_REL or grad_rel > TRAIN_GRAD_REL_L2 \
            or not all(np.isfinite(card_losses)):
        raise AssertionError("card and CPU training disagree")


# the optimizer-in-backward XL configuration (JAX `bench.py --xl`,
# bench.py:146-171): the train CLI's flags, batch 16 of [16, 8, 32, 32]
# latents (`--synthetic_t_choices 8`), L = 1040, the demo DiT's width
XL_ARGV = ("--model_width", "2048", "--model_depth", "24", "--batch_size",
           "16", "--synthetic_t_choices", "8", "--optimizer_in_backward",
           "true", "--nu_factored", "true", "--param_dtype", "bf16",
           "--moments_dtype", "bf16")
# beside it the standard step at the XL width: batch 8, fp32 parameters,
# bf16 moments (the demo-width cell of the sharded-training runs)
XL_STD_ARGV = ("--model_width", "2048", "--model_depth", "24",
               "--batch_size", "8", "--synthetic_t_choices", "8",
               "--moments_dtype", "bf16")
XL_LATENT, XL_L, XL_STEPS = (16, 8, 32, 32), 1040, 4
# the XL in-backward step's MLP activations (batch 16, L = 1040, 4·2048)
XL_GELU = (16, XL_L, MLP)


def xl_block_leaves():
    """Name → shape of one block of the XL DiT (the train CLI's config)."""
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT
    from video_diffusion_speedrun_tpu_torch.train.__main__ import (
        build_config,
        parse_args,
    )

    model = DiT(build_config(parse_args(list(XL_ARGV))).model,
                device="meta")
    return {n: tuple(p.shape) for n, p in model.blocks[0].named_parameters()}


def adamw_bf16_row(dev):
    """Row 17 in its bf16 mode: bf16 parameters and gradients with bf16
    moments, on one XL block's leaves (all exact ν), 3 steps against the
    twin; timed beside the twin and `torch.optim.AdamW(fused=True)`."""
    from video_diffusion_speedrun_tpu_torch.ops import fused_adamw as fw

    name = "adamw_multi_tensor<bf16>"
    gen = torch.Generator(device=dev).manual_seed(9)
    b1, b2, eps = 0.95, 0.99, 1e-8
    shapes = list(xl_block_leaves().values())
    bf = torch.bfloat16
    ps = [(torch.randn(sh, generator=gen, device=dev) * 0.02).to(bf)
          for sh in shapes]
    ms_, vs = ([torch.zeros_like(p) for p in ps] for _ in "mv")
    lrs = [T_LR * 32 / sh[-1] for sh in shapes]
    wds = [0.1 * sh[-1] / 1024 for sh in shapes]
    kern = fw.MultiTensorAdamW(ps, ms_, vs, lrs, wds, b1, b2, eps)
    n = sum(p.numel() for p in ps)
    lr_atol = torch.cat([torch.full((p.numel(),), 2.0 ** -7 * lr, device=dev)
                         for p, lr in zip(ps, lrs)])
    what = f"bf16 parameters and moments, one XL block's {len(shapes)} leaves"
    err = 0.0
    for step in range(3):
        # each step from the kernel's state, so that one update is held
        # against one update
        twin, mt, vt = ([t.clone() for t in ts] for ts in (ps, ms_, vs))
        grads = [(torch.randn(sh, generator=gen, device=dev) * 1e-3).to(bf)
                 for sh in shapes]
        sc = fw.step_scalars(step, 1.0 - step / 8, b1, b2)
        kern(grads, *sc)
        for i, g in enumerate(grads):
            fw.adamw_leaf_update_plain(twin[i], mt[i], vt[i], g, lrs[i],
                                       wds[i], *sc, b1, b2, eps)
        torch.cuda.synchronize()
        err = max(err, check_close(
            name, f"{what}, step {step}, p",
            torch.cat([p.flatten() for p in ps]),
            torch.cat([p.flatten() for p in twin]), 2.0 ** -7, lr_atol,
            "one bf16 ulp: the twin's reciprocal division moves the fp32 "
            "delta by an ulp, and its bf16 roundings can fall the other "
            "way"))
        err = max(err, check_close(
            name, f"{what}, step {step}, m, v",
            torch.cat([t.flatten() for t in ms_ + vs]),
            torch.cat([t.flatten() for t in mt + vt]), 0.0, 0.0,
            "no division: bit-equal"))
    grads = [(torch.randn(sh, generator=gen, device=dev) * 1e-3).to(bf)
             for sh in shapes]
    sc = fw.step_scalars(3, 1.0, b1, b2)
    ms = cuda_ms(lambda: kern(grads, *sc), iters=20, warmup=2)

    def twin_step():
        for p, m, v, g, lr, wd in zip(twin, mt, vt, grads, lrs, wds):
            fw.adamw_leaf_update_plain(p, m, v, g, lr, wd, *sc, b1, b2, eps)

    plain_ms = cuda_ms(twin_step, iters=3, warmup=1)
    # yardstick only: PyTorch's fused AdamW over the same bf16 leaves
    lib_p = [p.clone() for p in ps]
    for p, g in zip(lib_p, grads):
        p.grad = g
    lib = torch.optim.AdamW(lib_p, lr=1e-3, betas=(b1, b2), eps=eps,
                            weight_decay=0.1, fused=True)
    lib_ms = cuda_ms(lib.step, iters=20, warmup=2)
    # reads p, g, m, v and writes p, m, v, 2 bytes each; ~17 fp32 operations
    bms, by = bound(14 * n, 0, 17 * n)
    log(f"[kernels] {name}: {len(shapes)} leaves, {n / 1e6:.1f} M params: "
        f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, torch AdamW(fused) "
        f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{14 * n / ms / 1e6:.1f} GB/s")
    del ps, twin, ms_, vs, mt, vt, grads, lib, lib_p
    torch.cuda.empty_cache()
    return {name: dict(
        name=name, route="cuda",
        source="video_diffusion_speedrun_tpu_torch/csrc/adamw_multi_tensor.cu",
        replaces="video_diffusion_speedrun_tpu/ops/fused_adamw.py:66",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=lib_ms)}


def factored_bound(n: int):
    """The factored-ν update's bound for n bf16 elements: g read for the
    sums, then g, m and p read and m and p written (12 bytes an element;
    the factors are a few kB), ~18 fp32 operations an element."""
    return bound(12 * n, 0, 18 * n)


def xl_factored_group(dev, gen):
    """One XL block group's 8 factored weights on the card in the XL
    configuration's dtypes (bf16 parameters, gradients and μ, fp32
    factors), the muP-like lr and wd of each, bf16 gradients, and the
    factored-ν kernel over them."""
    from video_diffusion_speedrun_tpu_torch.ops import fused_adamw as fw
    from video_diffusion_speedrun_tpu_torch.train.optim import FNu

    bf = torch.bfloat16
    shapes = [sh for sh in xl_block_leaves().values() if len(sh) == 2]
    ps = [(torch.randn(sh, generator=gen, device=dev) * 0.02).to(bf)
          for sh in shapes]
    ms_ = [torch.zeros_like(p) for p in ps]
    nus = [FNu(torch.zeros(sh[1], device=dev), torch.zeros(sh[0], device=dev))
           for sh in shapes]
    lrs = [T_LR * 32 / sh[-1] for sh in shapes]
    wds = [0.1 * sh[-1] / 1024 for sh in shapes]
    grads = [(torch.randn(sh, generator=gen, device=dev) * 1e-3).to(bf)
             for sh in shapes]
    kern = fw.FactoredAdamW(ps, ms_, [n.vr for n in nus], [n.vc for n in nus],
                            shapes, lrs, wds, 0.95, 0.99, 1e-8)
    return dict(shapes=shapes, ps=ps, ms=ms_, nus=nus, lrs=lrs, wds=wds,
                grads=grads, kernel=kern, n=sum(p.numel() for p in ps))


def factored_adamw_row(dev):
    """The factored-ν kernel (`csrc/factored_adamw.cu`) against its twin
    `factored_leaf_update` on one XL block group's 8 factored weights, 3
    steps each from the kernel's state (m bit for bit; the factors within
    rtol 1e-6, the sums of g² in another order; p within one bf16 ulp plus
    one of the step), then the group's two launches timed beside their
    bound and the twin. No library call computes this function."""
    from video_diffusion_speedrun_tpu_torch.ops import fused_adamw as fw
    from video_diffusion_speedrun_tpu_torch.train.optim import (
        FNu,
        factored_leaf_update,
    )

    name = "factored_adamw"
    gen = torch.Generator(device=dev).manual_seed(11)
    b1, b2, eps = 0.95, 0.99, 1e-8
    fac = xl_factored_group(dev, gen)
    ps, ms_, nus, kern = fac["ps"], fac["ms"], fac["nus"], fac["kernel"]
    shapes, lrs, wds, n = fac["shapes"], fac["lrs"], fac["wds"], fac["n"]
    what = f"one XL block group's {len(shapes)} factored weights (bf16)"
    err = 0.0
    for step in range(3):
        before = [p.clone() for p in ps]
        twin, mt = [p.clone() for p in ps], [m.clone() for m in ms_]
        nut = [FNu(nu.vr.clone(), nu.vc.clone()) for nu in nus]
        grads = [(torch.randn(sh, generator=gen, device=dev) * 1e-3).to(
            torch.bfloat16) for sh in shapes]
        sc = fw.step_scalars(step, 1.0 - step / 8, b1, b2)
        kern(grads, *sc)
        for i, g in enumerate(grads):
            factored_leaf_update(twin[i], mt[i], nut[i], g, lrs[i], wds[i],
                                 *sc, b1, b2, eps, shapes[i])
        torch.cuda.synchronize()
        got, want = (torch.cat([p.flatten().float() for p in t])
                     for t in (ps, twin))
        step_atol = 2.0 ** -7 * (want - torch.cat(
            [p.flatten().float() for p in before])).abs()
        err = max(err, check_close(
            name, f"{what}, step {step}, p", got, want, 2.0 ** -7, step_atol,
            "one bf16 ulp, and one of the step: the twin divides by bc1 and "
            "bc2 through a reciprocal"))
        err = max(err, check_close(
            name, f"{what}, step {step}, m",
            torch.cat([m.flatten() for m in ms_]),
            torch.cat([m.flatten() for m in mt]), 0.0, 0.0,
            "no division: bit-equal"))
        err = max(err, check_close(
            name, f"{what}, step {step}, vr, vc",
            torch.cat([t for nu in nus for t in nu]),
            torch.cat([t for nu in nut for t in nu]), 1e-6, 0.0,
            "the sums of g² in another order"))
        del before, twin, mt, nut, grads
    grads, sc = fac["grads"], fw.step_scalars(3, 1.0, b1, b2)
    ms = cuda_ms(lambda: kern(grads, *sc), iters=20, warmup=2)

    def twin_step():
        for p, m, nu, g, sh, lr, wd in zip(ps, ms_, nus, grads, shapes, lrs,
                                           wds):
            factored_leaf_update(p, m, nu, g, lr, wd, *sc, b1, b2, eps, sh)

    plain_ms = cuda_ms(twin_step, iters=3, warmup=1)
    bms, by = factored_bound(n)
    log(f"[kernels] {name}: {what}, {n / 1e6:.2f} M elements: kernel "
        f"{ms:.4f} ms ({12 * n / ms / 1e6:.1f} GB/s of the 12 bytes an "
        f"element), twin {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"kernel / bound {ms / bms:.2f}; no library call")
    del fac, ps, ms_, nus, kern, grads
    torch.cuda.empty_cache()
    return {name: dict(
        name=name, route="cuda",
        source="video_diffusion_speedrun_tpu_torch/csrc/factored_adamw.cu",
        replaces="video_diffusion_speedrun_tpu/train/inloop.py:88 (XLA work)",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=None)}


def hyvideo_rows(dev):
    """HunyuanVideo's three kernels (`ops/fused_mmdit.py`) against their
    twins at the benchmark cell's shapes, each within one bf16 ulp, then
    timed beside its bound, its twin and the nearest library calls: the
    q/k RMSNorm + RoPE in the double block's joint qkv (ld 3·D) and in the
    single block's `linear1` output (ld 3·D + F), in place over L rows of
    which the first HYV_IMG are rotated; the LayerNorm modulation over the
    single block's L rows and the double block's video rows; GELU-tanh
    over the double block's fc1 output (with its bias, in place) and from
    `linear1`'s MLP columns into the concatenation `linear2` reads (strided
    views). No library call computes the first; the yardsticks of the
    other two are `F.layer_norm` + the modulation, and `F.gelu` (tanh)."""
    import torch.nn.functional as F

    from video_diffusion_speedrun_tpu_torch.models.rope import (
        nd_rope_cos_sin,
    )
    from video_diffusion_speedrun_tpu_torch.ops import fused_mmdit as fm

    gen = torch.Generator(device=dev).manual_seed(31)
    d, h, f, n_img = HYV_D, HYV_H, HYV_F, HYV_IMG
    l = n_img + HYV_TXT
    source = "video_diffusion_speedrun_tpu_torch/ops/fused_mmdit.py"
    rows = {}
    ulp = "one bf16 ulp: the same fp32 math, rounded once"

    name = "qk_norm_rope"
    cos, sin = nd_rope_cos_sin(HYV_GRID, (16, 56, 56), 256.0, dev)
    w = [(1 + 0.1 * torch.randn(d // h, generator=gen, device=dev)
          ).bfloat16() for _ in range(4)]
    nbytes = 2 * l * 2 * d * 2 + 2 * n_img * (d // h // 2) * 4 + 4 * d // h * 2
    bms, by = bound(nbytes, 0, 8 * l * 2 * d)
    err, times = 0.0, []
    for ld, what in ((3 * d, "the double block's joint qkv"),
                     (3 * d + f, "the single block's linear1 output")):
        buf = (torch.randn(l, ld, generator=gen, device=dev) * 2).bfloat16()
        want = fm.qk_norm_rope_plain(buf.clone(), n_img, h, *w, cos, sin)
        got = fm.qk_norm_rope_cuda(buf.clone(), n_img, h, *w, cos, sin)
        err = max(err, check_close(name, f"[{l}, ld {ld}] ({what})", got,
                                   want, 2.0 ** -7, 1e-6, ulp))
        if not torch.equal(got[:, 2 * d:], buf[:, 2 * d:]):
            raise AssertionError(f"{name} wrote outside q and k ({what})")
        del want, got
        ms = cuda_ms(lambda: fm.qk_norm_rope_cuda(buf, n_img, h, *w, cos,
                                                  sin))
        plain_ms = cuda_ms(lambda: fm.qk_norm_rope_plain(
            buf, n_img, h, *w, cos, sin), iters=5, warmup=1)
        log(f"[kernels] {name} [{l}, ld {ld}] ({what}): kernel {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.1f} GB/s), twin {plain_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}), bound / kernel {100 * bms / ms:.1f}%; no "
            f"library call")
        times.append((ms, plain_ms))
        del buf
    rows[name] = dict(
        name=name, route="cuda",
        source="video_diffusion_speedrun_tpu_torch/csrc/qk_norm_rope.cu",
        replaces=None, max_abs_err=err, ms=times[0][0],
        plain_ms=times[0][1], bound_ms=bms, bound_by=by, library_ms=None)

    name = "ln_modulate"
    mod = torch.randn(1, 6 * d, generator=gen, device=dev).bfloat16()
    shift, scale = mod[:, :d], mod[:, d:2 * d]
    err, times = 0.0, []
    for rows_n, what in ((l, "a single block's L rows"),
                         (n_img, "a double block's video rows")):
        x = (torch.randn(1, rows_n, d, generator=gen, device=dev) * 3 + 1
             ).bfloat16()
        err = max(err, check_close(
            name, f"[1, {rows_n}, {d}] ({what})", fm.ln_modulate(x, shift,
                                                                 scale),
            fm.ln_modulate_plain(x, shift, scale), 2.0 ** -7, 1e-3, ulp))
        ms = cuda_ms(lambda: fm.ln_modulate(x, shift, scale))
        plain_ms = cuda_ms(lambda: fm.ln_modulate_plain(x, shift, scale),
                           iters=5, warmup=1)
        lib_ms = cuda_ms(lambda: F.layer_norm(x, (d,), eps=1e-6)
                         * (1 + scale[:, None]) + shift[:, None])
        n = rows_n * d
        bms, by = bound(2 * n * 2 + 2 * d * 2, 0, 5 * n)
        log(f"[kernels] {name} [1, {rows_n}, {d}] ({what}): kernel "
            f"{ms:.4f} ms ({2 * n * 2 / ms / 1e6:.1f} GB/s), twin "
            f"{plain_ms:.4f} ms, F.layer_norm + modulate {lib_ms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), bound / kernel "
            f"{100 * bms / ms:.1f}%")
        times.append((ms, plain_ms, lib_ms, bms, by))
        del x
    ms, plain_ms, lib_ms, bms, by = times[0]
    rows[name] = dict(name=name, route="triton", source=source,
                      replaces=None, max_abs_err=err, ms=ms,
                      plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                      library_ms=lib_ms)

    name = "gelu_tanh"
    err, times = 0.0, []
    bias = (torch.randn(f, generator=gen, device=dev) * 0.5).bfloat16()
    for rows_n, strided in ((n_img, False), (l, True)):
        if strided:
            what = "from linear1's MLP columns into the concatenation"
            y1 = (torch.randn(rows_n, 3 * d + f, generator=gen, device=dev)
                  * 3).bfloat16()
            cat = torch.zeros(rows_n, d + f, device=dev, dtype=torch.bfloat16)
            x, b, out = y1[:, 3 * d:], None, cat[:, d:]
        else:
            what = "a double block's fc1 output with its bias, in place"
            x = (torch.randn(rows_n, f, generator=gen, device=dev) * 3
                 ).bfloat16()
            b, out = bias, x
        want = fm.gelu_tanh_plain(x, b)
        got = fm.gelu_tanh(x.clone(), b, out=None if not strided else out)
        err = max(err, check_close(name, f"[{rows_n}, {f}] ({what})", got,
                                   want, 2.0 ** -7, 1e-5, ulp))
        if strided and not torch.equal(cat[:, :d], torch.zeros_like(
                cat[:, :d])):
            raise AssertionError(f"{name} wrote outside its view ({what})")
        del want, got
        ms = cuda_ms(lambda: fm.gelu_tanh(x, b, out=out))
        plain_ms = cuda_ms(lambda: fm.gelu_tanh_plain(x, b, out=out),
                           iters=5, warmup=1)
        lib_ms = cuda_ms(lambda: F.gelu(x if b is None else x + b,
                                        approximate="tanh"))
        n = rows_n * f
        bms, by = bound(2 * n * 2 + (0 if b is None else f * 2), 0, 20 * n)
        log(f"[kernels] {name} [{rows_n}, {f}] ({what}): kernel {ms:.4f} ms "
            f"({2 * n * 2 / ms / 1e6:.1f} GB/s), twin {plain_ms:.4f} ms, "
            f"F.gelu (tanh) {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"bound / kernel {100 * bms / ms:.1f}%")
        times.append((ms, plain_ms, lib_ms, bms, by))
        del x, out
        if strided:
            del y1, cat
    ms, plain_ms, lib_ms, bms, by = times[0]
    rows[name] = dict(name=name, route="triton", source=source,
                      replaces=None, max_abs_err=err, ms=ms,
                      plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                      library_ms=lib_ms)
    torch.cuda.empty_cache()
    return rows


def phase_hyvideo(dev):
    """HunyuanVideo at its published widths and depth (20 + 40 blocks, bf16
    weights, random) through the sampling CLI's `main` at the cell's size,
    HYV_STEPS Euler steps, the launch counters set to 0 just before it:
    returns the counts of this one run."""
    import tempfile

    from video_diffusion_speedrun_tpu_torch import sample

    reset_counters()
    report = {}
    with tempfile.TemporaryDirectory() as out:
        sample.main(["--model", "hunyuanvideo", "--random_weights",
                     "--height", str(8 * 2 * HYV_GRID[1]),
                     "--width", str(8 * 2 * HYV_GRID[2]),
                     "--num_latent_frames", str(HYV_GRID[0]),
                     "--inference_steps", str(HYV_STEPS), "--output", out],
                    report=report)
    latents = report.pop("latents")
    if not bool(torch.isfinite(latents).all()):
        raise AssertionError("hyvideo: the latents are not finite")
    counts = read_counters()
    log(f"[hyvideo] latents {tuple(latents.shape)}, {HYV_STEPS} steps in "
        f"{report['sample_s']:.2f} s; launches: "
        + ", ".join(f"{k} {counts[k]}" for k in
                    ("qk_norm_rope", "ln_modulate", "gelu_tanh",
                     "long_attention_fwd")))
    del latents, report
    torch.cuda.empty_cache()
    return counts


def main_hyvideo() -> int:
    """HunyuanVideo's kernel rows and its main-path launches alone: the
    `kernels` line of those three rows."""
    dev = torch.device("cuda")
    phase_build()
    rows = hyvideo_rows(dev)
    counts = phase_hyvideo(dev)
    kernels = [dict(row, launches=counts[name]) for name, row in rows.items()]
    unlaunched = [k["name"] for k in kernels if not k["launches"]]
    if unlaunched:
        raise AssertionError(f"kernels the main path never launched: "
                             f"{unlaunched}")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


def inloop_update_times(dev):
    """What the optimizer-in-backward step's update of one XL block costs
    on the card: the AdamW kernel on the block group's exact leaves (the
    biases and λ; the weights keep factored ν) and the factored-ν kernel on
    its weights, each against its bound; ms each, CUDA events."""
    from video_diffusion_speedrun_tpu_torch.ops import fused_adamw as fw

    gen = torch.Generator(device=dev).manual_seed(5)
    bf, b1, b2, eps = torch.bfloat16, 0.95, 0.99, 1e-8
    exact = [sh for sh in xl_block_leaves().values() if len(sh) < 2]

    def make(sh):
        p = (torch.randn(sh, generator=gen, device=dev) * 0.02).to(bf)
        g = (torch.randn(sh, generator=gen, device=dev) * 1e-3).to(bf)
        return p, torch.zeros_like(p), g

    ex = [make(sh) for sh in exact]
    kern = fw.MultiTensorAdamW([t[0] for t in ex], [t[1] for t in ex],
                               [torch.zeros_like(t[0]) for t in ex],
                               [1e-3] * len(ex), [0.0] * len(ex), b1, b2, eps)
    sc = fw.step_scalars(0, 1.0, b1, b2)
    grads = [t[2] for t in ex]
    kernel_ms = cuda_ms(lambda: kern(grads, *sc), iters=50, warmup=3)
    n_exact = sum(t[0].numel() for t in ex)
    kernel_bound, _ = bound(14 * n_exact, 0, 17 * n_exact)
    del ex, grads, kern
    fac = xl_factored_group(dev, gen)
    fac_ms = cuda_ms(lambda: fac["kernel"](fac["grads"], *sc), iters=20,
                     warmup=2)
    n_fac = fac["n"]
    fac_bound, _ = factored_bound(n_fac)
    del fac
    torch.cuda.empty_cache()
    return dict(kernel_ms=kernel_ms, kernel_bound=kernel_bound,
                n_exact=n_exact, factored_ms=fac_ms, factored_bound=fac_bound,
                n_factored=n_fac)


def phase_train_inloop(dev):
    """The XL configuration through the train CLI's `main` (phase 24 of
    the docstring): XL_STEPS optimizer-in-backward steps, then the
    standard step at the XL width and batch 8. Each run: the launch
    counters set to 0 just before `main` and read just after, the steps
    timed between synchronisations (step 0 warm-up), the last one
    profiled, the peak memory of the run. Returns both runs' counts."""
    import gc
    import tempfile

    from video_diffusion_speedrun_tpu_torch.train import __main__ as cli
    from video_diffusion_speedrun_tpu_torch.train import loop

    upd = inloop_update_times(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    runs, results = [], {}
    for tag, argv, attr, batch in (
            ("train-inloop", XL_ARGV, "inloop_step", 16),
            ("train-xl-standard", XL_STD_ARGV, "train_step", 8)):
        step_fn = getattr(loop, attr)
        losses, ms, prof = [], [], []

        def timed(*a, _fn=step_fn, **k):
            if len(ms) == XL_STEPS - 1:  # the last step: profiled
                out = []
                prof.append(profile_device(
                    lambda: out.append(_fn(*a, **k)), "one train step",
                    tag + "-profile", rows=12))
                losses.append(float(out[0]["loss"]))
                ms.append(float("nan"))
                return out[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = _fn(*a, **k)
            losses.append(float(m["loss"]))  # synchronises
            ms.append(1e3 * (time.perf_counter() - t0))
            return m

        setattr(loop, attr, timed)
        # what earlier phases left in reference cycles is not this run's
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counters()
        t0 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                # evaluate_every 1: `step % 1 == 1` never holds, so the run
                # neither evaluates nor writes an 11 GB checkpoint (the
                # ckpt phase covers both)
                cli.main([*argv, "--max_steps", str(XL_STEPS),
                          "--evaluate_every", "1", "--log_every", "1",
                          "--checkpoint_dir", tmp])
        finally:
            setattr(loop, attr, step_fn)
        wall = time.perf_counter() - t0
        launches = read_counters()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        inloop = attr == "inloop_step"
        per_step = train_step_launches(
            XL_L, depth=DEPTH, adamw=DEPTH + 1 if inloop else 1,
            bf16_params=inloop, factored=2 * DEPTH if inloop else 0)
        want = {k: XL_STEPS * v for k, v in per_step.items()}
        steady = float(np.median(ms[1:XL_STEPS - 1]))
        busy = prof[0][1] if prof and prof[0] else None
        log(f"[{tag}] {' '.join(argv)}: {XL_STEPS} steps in {wall:.1f} s "
            f"(the CLI's start-up included); losses {losses}; "
            f"{steady:.2f} ms per step (median of steps 1–{XL_STEPS - 2}, "
            f"{ms[:XL_STEPS - 1]}), device busy "
            f"{'not measured' if busy is None else f'{busy:.2f}'} ms of the "
            f"profiled step; peak memory {peak:.2f} GB ({held:.2f} GB held "
            f"before the run); {smi}")
        log(f"[{tag}] launches {launches}, expected {want}")
        if not all(np.isfinite(losses)) or len(losses) != XL_STEPS:
            raise AssertionError(f"{tag}: losses {losses}")
        if launches != want:
            raise AssertionError(f"{tag}: launch counts {launches} != {want}")
        results[tag] = (steady, busy, peak)
        runs.append(launches)
        gc.collect()
        torch.cuda.empty_cache()
    steady, busy, peak = results["train-inloop"]
    per_step_fac = DEPTH * upd["factored_ms"]
    log(f"[train-inloop] one block group's AdamW launch over its "
        f"{upd['n_exact']} exact elements (biases, λ): "
        f"{upd['kernel_ms']:.4f} ms, bound {upd['kernel_bound']:.5f} ms "
        f"(bytes); {DEPTH + 1} launches a step. The factored-ν kernel on "
        f"one block's {upd['n_factored'] / 1e6:.1f} M weight elements: "
        f"{upd['factored_ms']:.3f} ms (bound "
        f"{upd['factored_bound']:.3f} ms), × {DEPTH} = {per_step_fac:.1f} "
        f"ms a step, {100 * per_step_fac / steady:.1f}% of the "
        f"{steady:.2f} ms step")
    std = results["train-xl-standard"]
    log(f"[train-inloop] XL in-backward at batch 16: {steady:.2f} ms, peak "
        f"{peak:.2f} GB; the standard XL step at batch 8 (fp32 parameters, "
        f"bf16 moments): {std[0]:.2f} ms, peak {std[2]:.2f} GB; {smi}")
    return runs


def phase_inloop_parity(dev):
    """Depth 2 at the canonical width, L = 528, 3 steps on the same
    weights and injected batches: the optimizer-in-backward step with the
    XL flags (bf16 parameters and moments, factored ν) on the card
    (kernels) against the CPU (fp32 compute, twins); and on fp32
    parameters with exact ν against the card's standard step. The losses
    and the step-1 gradients the optimizer received, at the train-parity
    limits."""
    from video_diffusion_speedrun_tpu_torch.core.config import (
        OptimizerConfig,
        TrainConfig,
    )
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT
    from video_diffusion_speedrun_tpu_torch.train.inloop import inloop_step
    from video_diffusion_speedrun_tpu_torch.train.optim import MupAdamW
    from video_diffusion_speedrun_tpu_torch.train.step import train_step

    steps, b = 3, 4
    bf = torch.bfloat16
    cpu_f32 = DiT(train_config(2, compute_dtype=torch.float32,
                               attention_impl="fused", fused_adaln="fused"),
                  device="cpu", init_std_factor=0.1, seed=0)
    randomize_zero_layers(cpu_f32, torch.Generator().manual_seed(1))
    weights = cpu_f32.state_dict()
    cpu_bf = DiT(cpu_f32.cfg.replace(param_dtype=bf), device="cpu")
    cpu_bf.load_state_dict(weights)
    del cpu_f32

    rng = np.random.default_rng(0)
    c, t, hh, ww = T_LATENT
    data = [dict(
        latent=rng.standard_normal((b, c, t, hh, ww), np.float32),
        context=rng.standard_normal((b, CTX_LEN, CTX_DIM), np.float32) * 0.05,
        timesteps=rng.uniform(0.02, 0.98, b).astype(np.float32),
        noise=rng.standard_normal((b, c, t // 2 * 2, hh, ww), np.float32),
        rope_offsets=rng.integers(0, 100, 3)) for _ in range(steps)]

    def opt_cfg(**kw):
        return OptimizerConfig(learning_rate=T_LR, scheduler="linear",
                               warmup_steps=0, **kw)

    def run(model, device, ocfg, step_fn):
        cfg = TrainConfig(model=model.cfg, batch_size=b, max_steps=steps,
                          caption_dropout=0.0, optimizer=ocfg)
        opt = MupAdamW(model.named_parameters(), T_LR, steps, ocfg)
        grads = {}
        step, update = opt.step, opt.update_group

        def keep(names, gs):
            for n, g in zip(names, gs):
                if g is not None and opt.count == 0:
                    grads[n] = g.detach().float().cpu()

        opt.step = lambda gs: (keep(opt.names, gs), step(gs))
        opt.update_group = lambda group, gs: (keep(
            [opt.names[i] for i in opt.groups[group]], gs),
            update(group, gs))
        batches = [{k: torch.from_numpy(np.asarray(v)).to(device)
                    for k, v in bt.items()} for bt in data]
        losses = [float(step_fn(model, opt, bt, None, cfg)["loss"])
                  for bt in batches]
        return losses, grads, sum(opt.factored)

    xl = opt_cfg(moments_dtype=bf, in_backward=True, nu_factored=True)
    t0 = time.perf_counter()
    cpu = run(cpu_bf, "cpu", xl, inloop_step)
    cpu_s = time.perf_counter() - t0
    card_bf = DiT(train_config(2, param_dtype=bf), device=dev)
    card_bf.load_state_dict(weights)
    card = run(card_bf, dev, xl, inloop_step)
    del card_bf
    pairs = [(f"in-backward, XL flags: card vs CPU (CPU run {cpu_s:.1f} s)",
              card, cpu)]
    for_std = []
    for ocfg, fn in ((opt_cfg(in_backward=True), inloop_step),
                     (opt_cfg(), train_step)):
        model = DiT(train_config(2), device=dev)
        model.load_state_dict(weights)
        for_std.append(run(model, dev, ocfg, fn))
        del model
    pairs.append(("in-backward vs standard step, fp32 parameters, on the "
                  "card", *for_std))
    torch.cuda.empty_cache()
    for what, (losses, grads, n_fac), (ref_losses, ref_grads, _) in pairs:
        loss_rel = max(abs(a / w - 1) for a, w in zip(losses, ref_losses))
        rel, (worst, worst_rel) = grad_rel_l2(grads, ref_grads)
        ok = (loss_rel <= TRAIN_LOSS_REL and rel <= TRAIN_GRAD_REL_L2
              and all(np.isfinite(losses)))
        log(f"[inloop-parity] {what}: depth 2, width {T_WIDTH}, batch {b}, "
            f"L={T_L}, {steps} steps, {n_fac} leaves with factored ν; losses "
            f"{losses} vs {ref_losses}: relative {loss_rel:.3e} (tol "
            f"{TRAIN_LOSS_REL}); step-1 gradients relative L2 {rel:.3e}, "
            f"worst tensor {worst} {worst_rel:.3e} (tol {TRAIN_GRAD_REL_L2})"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"inloop-parity: {what} disagree")


def phase_serve_cp(dev, model, context):
    """The demo DiT at the sampling CLI's default 512×512×16 (L = 8208)
    over `LocalRing(cp)` for cp in CP_SERVE: one request of CP_STEPS Euler
    steps each, counters per step, against the same request without a
    ring. Returns each run's counts."""
    from video_diffusion_speedrun_tpu_torch.core.config import SamplingConfig
    from video_diffusion_speedrun_tpu_torch.parallel.ring import LocalRing
    from video_diffusion_speedrun_tpu_torch.sampling.euler import (
        generate_latents,
    )

    sampling = SamplingConfig(inference_steps=CP_STEPS, cfg_scale=6.0,
                              height=LONG_PX, width=LONG_PX,
                              num_latent_frames=LONG_FRAMES, seed=SEEDS[0])
    ref = generate_latents(model, context, sampling)
    noise = torch.randn(ref.shape, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEEDS[0])).bfloat16().float()
    runs = []
    for cp in CP_SERVE:
        tag = f"serve-cp{cp}"
        launches, (lat,) = phase_serve(dev, model, context, LONG_PX,
                                       LONG_FRAMES, CP_STEPS, SEEDS[:1], tag,
                                       ring=LocalRing(cp))
        rel = ((lat - ref).norm() / (ref - noise).norm()).item()
        ok = rel <= CP_REL_L2
        log(f"[{tag}] {CP_STEPS} steps at L={LONG_L}: relative L2 of the "
            f"latent update against the run without a ring {rel:.3e} (tol "
            f"{CP_REL_L2}: the ring merges each chunk's bf16 o and rounds "
            f"again, through {DEPTH} blocks) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the ring and the one-card path disagree")
        runs.append(launches)
    return runs


def phase_train_cp(dev):
    """The canonical DiT at batch 2, L = 8208 (the train-long run's
    config) with its zero-initialised layers made random, so that the loss
    and every gradient go through attention: CP_TRAIN_STEPS steps without
    a ring, then over `LocalRing(cp)` for cp in CP_TRAIN, through Trainer
    and train_step on the same batches and draws; each ring run's losses
    and first-step gradients against the run without a ring. Returns each
    ring run's counts."""
    from video_diffusion_speedrun_tpu_torch.parallel.ring import LocalRing

    extra = ("--moments_dtype", "bf16")
    _, ref_losses, ref_grads, _ = phase_train(
        dev, TL_BATCH, TL_LATENT, CP_TRAIN_STEPS, extra, "train-cp-ref",
        evaluate=False, probe=True)
    runs = []
    for cp in CP_TRAIN:
        tag = f"train-cp{cp}"
        launches, losses, grads, _ = phase_train(
            dev, TL_BATCH, TL_LATENT, CP_TRAIN_STEPS, extra, tag,
            evaluate=False, ring=LocalRing(cp), probe=True)
        rel = max(abs(a / w - 1) for a, w in zip(losses, ref_losses))
        grad_rel, (worst, worst_rel) = grad_rel_l2(grads, ref_grads)
        ok = (rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2
              and worst_rel <= TRAIN_GRAD_REL_L2)
        log(f"[{tag}] losses {losses} against {ref_losses} without a ring: "
            f"relative difference {rel:.3e} (tol {TRAIN_LOSS_REL}); "
            f"first-step gradient relative L2 {grad_rel:.3e}, worst tensor "
            f"{worst} {worst_rel:.3e} (tol {TRAIN_GRAD_REL_L2} each) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("ring training and one-card training "
                                 "disagree")
        runs.append(launches)
    return runs


# the remat policies (train-remat): each on the long canonical cell
# (train-long's: batch 2, L = 8208, bf16 moments) and two on the XL width
# (the standard XL step of train-inloop: batch 8, L = 1040, fp32
# parameters, bf16 moments); REMAT_STEPS steps a run, the first a warm-up
REMAT_POLICIES = ("nothing", "dots", "attn", "dots_attn")
REMAT_XL_POLICIES = ("nothing", "dots_attn")
REMAT_STEPS = 4
# every policy's first-step loss and gradients against "nothing" in the
# same call: the recompute reruns or reuses the same deterministic
# launches, so the bits are expected equal; the phase fails above this
REMAT_REL = 1e-6
# the attention rows whose forward the kept policies launch once a block
REMAT_ROWS = (("short_attention_fwd<rope>", "long_attention_fwd",
               "short_attention_fwd<norope>"),
              ("short_attention_bwd<rope>", "long_attention_bwd",
               "short_attention_bwd<norope>"))


def remat_run(dev, tag: str, argv, latent, policy: str, ref, smi: str):
    """The train CLI's configuration `argv` with `--remat_policy policy`
    (the zero-initialised layers made random), on `latent` rows: the first
    step's loss and gradients, held against `ref` (those of "nothing"; None
    for "nothing" itself); then REMAT_STEPS steps of `train_step` with the
    counters set to 0 just before and read just after, peak memory from a
    collected heap (and on the first step the memory when the backward
    starts), and one profiled step. Returns (counts, loss and
    gradients, ms per step, busy ms, peak GB)."""
    import gc

    from video_diffusion_speedrun_tpu_torch.train.__main__ import (
        build_config,
        parse_args,
    )
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer
    from video_diffusion_speedrun_tpu_torch.train.step import train_step

    cfg = build_config(parse_args([*argv, "--remat_policy", policy]))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, synthetic_shape=tuple(latent)))
    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer(cfg, device=dev)
    randomize_zero_layers(trainer.model,
                          torch.Generator(device=dev).manual_seed(1))
    memory = {}
    first = first_step(trainer, cfg, memory=memory)
    log(f"[{tag}] first step's memory: " + ", ".join(
        f"{k} {v:.2f} GB" for k, v in memory.items()))
    if ref is not None:
        loss_rel = abs(first[0] / ref[0] - 1)
        rel, (worst, worst_rel) = grad_rel_l2(first[1], ref[1])
        bits = first[0] == ref[0] and all(
            torch.equal(first[1][n], ref[1][n]) for n in ref[1])
        ok = max(loss_rel, rel, worst_rel) <= REMAT_REL
        log(f"[{tag}] first step against 'nothing': loss {first[0]!r} vs "
            f"{ref[0]!r} (relative {loss_rel:.3e}), gradients relative L2 "
            f"{rel:.3e}, worst tensor {worst} {worst_rel:.3e} (tol "
            f"{REMAT_REL}); bits equal: {bits} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: remat policy {policy} changed the "
                                 "first step")
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    loader = trainer.batches("train")
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    losses, ms = [], []
    for _ in range(REMAT_STEPS):
        batch = next(loader)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(trainer.model, trainer.opt, batch, gen, cfg)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    l = latent_len(latent)
    kept = policy in ("attn", "dots_attn")
    want = {k: REMAT_STEPS * v for k, v in train_step_launches(
        l, depth=cfg.model.depth, kept_attention=kept).items()}
    batch = next(loader)
    prof = profile_device(lambda: train_step(trainer.model, trainer.opt,
                                             batch, gen, cfg),
                          "one train step", tag + "-profile", rows=8)
    busy = None if prof is None else prof[1]
    steady = float(np.median(ms[1:]))
    per_step = {k: launches[k] // REMAT_STEPS for k in REMAT_ROWS[0]
                + REMAT_ROWS[1] if launches[k]}
    log(f"[{tag}] --remat_policy {policy}: {steady:.2f} ms per step (median "
        f"of steps 1–{REMAT_STEPS - 1}, {[round(t, 2) for t in ms]}), "
        f"device busy {'not measured' if busy is None else f'{busy:.2f}'} "
        f"ms of the profiled step; peak memory {peak:.2f} GB ({held:.2f} GB "
        f"held before the steps); attention launches per step {per_step}; "
        f"losses {losses}; {smi}")
    log(f"[{tag}] launches {launches}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches} != {want}")
    del trainer, loader, batch
    return launches, first, steady, busy, peak


def phase_train_remat(dev):
    """The remat policies through the train CLI's flags (phase 26 of the
    docstring): each of REMAT_POLICIES on the long canonical cell, and
    REMAT_XL_POLICIES at the XL width; every run's first step against
    "nothing" of its cell. Returns each run's counts."""
    import gc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    long_argv = train_argv(T_DEPTH, batch=TL_BATCH,
                           extra=("--moments_dtype", "bf16"))
    cells = (("train-remat-long", long_argv, TL_LATENT, REMAT_POLICIES),
             ("train-remat-xl", list(XL_STD_ARGV), XL_LATENT,
              REMAT_XL_POLICIES))
    runs = []
    for cell, argv, latent, policies in cells:
        ref, res = None, {}
        for policy in policies:
            launches, first, steady, busy, peak = remat_run(
                dev, f"{cell}-{policy}", argv, latent, policy, ref, smi)
            ref = ref or first
            res[policy] = (steady, busy, peak)
            runs.append(launches)
            gc.collect()
            torch.cuda.empty_cache()
        base = res["nothing"]
        log(f"[{cell}] L={latent_len(latent)}: " + "; ".join(
            f"{p} {ms:.2f} ms ({ms - base[0]:+.2f}), busy "
            f"{'not measured' if b is None else f'{b:.2f}'}, peak "
            f"{gb:.2f} GB ({gb - base[2]:+.2f})"
            for p, (ms, b, gb) in res.items()) + f"; {smi}")
        del ref
        gc.collect()
    return runs


def cp_fallback_serve(dev):
    """The demo DiT without RoPE (its positional table widened to L =
    8208) at depth 2, 2 Euler steps at 512×512×16, over `LocalRing(2)`
    (the gathered attention) against no ring (the long kernel without
    RoPE), both bf16 on the card."""
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT
    from video_diffusion_speedrun_tpu_torch.parallel.ring import LocalRing
    from video_diffusion_speedrun_tpu_torch.sample import demo_config
    from video_diffusion_speedrun_tpu_torch.sampling.euler import (
        euler_cfg_sample,
    )

    cfg = demo_config(WIDTH, 2, HEAD_DIM, CTX_DIM, param_dtype=torch.bfloat16,
                      use_rope=False, max_tokens_no_rope=LONG_L)
    model = DiT(cfg, device=dev, init_std_factor=0.1, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    randomize_zero_layers(model, gen)
    with torch.no_grad():
        model.positional_embedding.normal_(generator=gen)
    rng = np.random.default_rng(0)
    shape = (1, 16, LONG_FRAMES, LONG_PX // 8, LONG_PX // 8)
    noise = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        dev).bfloat16()
    ctx = torch.from_numpy(rng.standard_normal((1, CTX_LEN, CTX_DIM),
                                               np.float32) * 0.05).to(dev)
    outs = {}
    for name, ring in (("no ring", None), ("LocalRing(2)", LocalRing(2))):
        reset_counters()
        outs[name] = euler_cfg_sample(model, noise, ctx.bfloat16(),
                                      num_steps=2, cfg_scale=6.0,
                                      context_parallel=ring).float()
        outs[name + " launches"] = read_counters()
    self_attn = {k: v for k, v in outs["LocalRing(2) launches"].items()
                 if k in ("ring_attention_fwd", "long_attention_fwd",
                          "long_attention_fwd<bias>")}
    d_ref = outs["no ring"] - noise.float()
    rel = ((outs["LocalRing(2)"] - outs["no ring"]).norm()
           / d_ref.norm()).item()
    ok = (rel <= CP_REL_L2 and bool(torch.isfinite(outs["LocalRing(2)"])
                                    .all())
          and not any(self_attn.values())
          # depth 2 × 2 Euler steps, one CFG-batched forward each
          and outs["no ring launches"]["long_attention_fwd"] == 2 * 2)
    log(f"[cp-fallback] no-RoPE demo DiT, depth 2, L={LONG_L}, 2 Euler "
        f"steps: LocalRing(2) (gathered attention; self-attention kernel "
        f"launches {self_attn}) against no ring (the long kernel, "
        f"{outs['no ring launches']['long_attention_fwd']} launches): "
        f"relative L2 of the latent update {rel:.3e} (tol {CP_REL_L2}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cp-fallback: the gathered attention and the "
                             "one-card path disagree")


def cp_fallback_train(dev, tag: str, argv_extra, **overrides):
    """The canonical DiT at depth 2 (the train CLI's flags plus
    `argv_extra`, config `overrides`), its zero-initialised layers (and a
    no-RoPE model's positional table) made random: 3 steps on the same
    batches and draws without a ring and over `LocalRing(2)`, losses and
    first-step gradients held at the CP limits."""
    from video_diffusion_speedrun_tpu_torch.parallel.ring import LocalRing
    from video_diffusion_speedrun_tpu_torch.train.__main__ import (
        build_config,
        parse_args,
    )
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer
    from video_diffusion_speedrun_tpu_torch.train.step import train_step

    cfg = build_config(parse_args(train_argv(2, batch=T_BATCH,
                                             extra=argv_extra)))
    cfg = dataclasses.replace(cfg, model=cfg.model.replace(**overrides),
                              data=dataclasses.replace(
                                  cfg.data, synthetic_shape=T_LATENT))
    res = {}
    for name, ring in (("no ring", None), ("LocalRing(2)", LocalRing(2))):
        trainer = Trainer(cfg, device=dev, context_parallel=ring)
        gen = torch.Generator(device=dev).manual_seed(1)
        randomize_zero_layers(trainer.model, gen)
        if not cfg.model.use_rope:
            with torch.no_grad():
                trainer.model.positional_embedding.normal_(generator=gen)
        _, grads = first_step(trainer, cfg, ring)
        g = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        loader = trainer.batches("train")
        reset_counters()
        losses = [float(train_step(trainer.model, trainer.opt, next(loader),
                                   g, cfg, ring)["loss"]) for _ in range(3)]
        res[name] = (losses, grads, read_counters())
        del trainer, loader
    (ref_losses, ref_grads, _), (losses, grads, launches) = (
        res["no ring"], res["LocalRing(2)"])
    rel = max(abs(a / w - 1) for a, w in zip(losses, ref_losses))
    grad_rel, (worst, worst_rel) = grad_rel_l2(grads, ref_grads)
    ring_launches = {k: launches[k] for k in (
        "ring_attention_fwd", "ring_attention_bwd", "long_attention_fwd<bias>",
        "long_attention_bwd<bias>")}
    ok = (rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2
          and worst_rel <= TRAIN_GRAD_REL_L2 and np.isfinite(losses).all()
          and not any(ring_launches.values()))
    log(f"[{tag}] depth 2, L={T_L}, {overrides or argv_extra}: LocalRing(2) "
        f"(gathered attention; ring kernel launches {ring_launches}) losses "
        f"{losses} against {ref_losses} without a ring: relative "
        f"difference {rel:.3e} (tol {TRAIN_LOSS_REL}); first-step gradient "
        f"relative L2 {grad_rel:.3e}, worst tensor {worst} {worst_rel:.3e} "
        f"(tol {TRAIN_GRAD_REL_L2} each) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: the gathered attention and the "
                             "one-card path disagree")


def phase_cp_fallback(dev):
    """Context parallelism where the ring does not run (phase 27 of the
    docstring): a no-RoPE long sampling model and a no-RoPE canonical
    training model, and the canonical model at head_dim 32 in bf16 (the
    kernels refuse it; "auto" gathers k and v), each over `LocalRing(2)`
    against no ring; and "fused" at head_dim 32 under CP raises."""
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT
    from video_diffusion_speedrun_tpu_torch.parallel.ring import LocalRing

    cp_fallback_serve(dev)
    cp_fallback_train(dev, "cp-fallback-norope", (), use_rope=False)
    hd32 = ("--model_head_dim", "32")
    cp_fallback_train(dev, "cp-fallback-hd32", hd32)
    model = DiT(train_config(2, attention_impl="fused").replace(
        num_heads=T_WIDTH // 32), device=dev)
    x = torch.randn((1, *T_LATENT), device=dev)
    try:
        with torch.no_grad():
            model(x, torch.zeros(1, 8, model.cfg.cross_attn_input_size,
                                 device=dev), torch.full((1,), 0.5,
                                                         device=dev),
                  context_parallel=LocalRing(2))
    except ValueError as e:
        log(f"[cp-fallback] attention_impl='fused' at head_dim 32 under "
            f"LocalRing(2) raises, as JAX's 'pallas': {e}")
    else:
        raise AssertionError("'fused' at head_dim 32 under CP did not raise")


def _nccl_ring_worker(rank: int, port: int, inputs, out_path: str) -> None:
    """One rank of `phase_nccl_ring`: `cp_rope_flash_attention` over a
    `DistRing` of 2 processes on NCCL, rank r on card r."""
    import torch.distributed as dist

    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa
    from video_diffusion_speedrun_tpu_torch.parallel.ring import DistRing

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        q, k, v, cos, sin = (t.to(f"cuda:{rank}") for t in inputs)
        out = fa.cp_rope_flash_attention(q, k, v, cos, sin,
                                         WIDTH // HEAD_DIM,
                                         DistRing(dist.group.WORLD))
        if rank == 0:
            torch.save(out.cpu(), out_path)
    finally:
        dist.destroy_process_group()


def phase_nccl_ring(dev):
    """`DistRing` over NCCL between 2 processes and cards against
    `LocalRing(2)` on one card, at the serve shape (B=2, H=16, L = 8208),
    where the machine has 2 cards; otherwise one line says why not."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    from video_diffusion_speedrun_tpu_torch.models.rope import rope_cos_sin
    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa
    from video_diffusion_speedrun_tpu_torch.parallel.ring import LocalRing

    n = torch.cuda.device_count()
    if n < 2:
        log(f"[nccl-ring] not run: this machine has {n} CUDA card; the "
            f"NCCL ring needs 2 (the CPU tests run DistRing over gloo)")
        return
    gen = torch.Generator(device=dev).manual_seed(16)
    hd = WIDTH
    q, k, v = (torch.randn(2, LONG_L, hd, generator=gen, device=dev)
               .bfloat16() for _ in range(3))
    grid = (LONG_FRAMES // 2, LONG_PX // 16, LONG_PX // 16)
    cos, sin = rope_cos_sin(HEAD_DIM, *grid, torch.tensor([3, 5, 7],
                                                          device=dev),
                            num_registers=16)
    want = fa.cp_rope_flash_attention(q, k, v, cos, sin, WIDTH // HEAD_DIM,
                                      LocalRing(2)).cpu()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "out.pt")
        mp.start_processes(_nccl_ring_worker, args=(
            port, [t.cpu() for t in (q, k, v, cos, sin)], path), nprocs=2,
            start_method="spawn")
        got = torch.load(path)
    err = (got.float() - want.float()).abs().max().item()
    tol = LONG_FWD_REL * want.float().abs().max().item()
    ok = err <= tol
    log(f"[nccl-ring] DistRing over 2 cards (NCCL) against LocalRing(2): "
        f"max_abs_err {err:.3e} (tol {tol:.3e}: two bf16 ulps of the largest "
        f"|o|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the NCCL ring and LocalRing disagree")


# the train-fsdp phase: steps of each mesh, the meshes on one card (2
# processes over gloo) and over NCCL with 2 and 4 cards (replica, fsdp,
# context, tensor)
FSDP_STEPS = 3
FSDP_ONE_CARD = (("fsdp 2", (1, 2, 1, 1)), ("tensor 2", (1, 1, 1, 2)))
FSDP_CARDS = {2: FSDP_ONE_CARD,
              4: (("replica 2 x fsdp 2", (2, 2, 1, 1)),
                  ("fsdp 2 x tensor 2", (1, 2, 1, 2)))}
# the optimizer-in-backward step at fsdp 2 (gathers and reduce-scatters of
# its own, the factored ν's sums over fsdp), against one process of it
FSDP_INLOOP = ("in-backward fsdp 2", (1, 2, 1, 1))
FSDP_INLOOP_STEPS = 2  # its per-leaf collectives cross the host (gloo)
INLOOP_FLAGS = ("--optimizer_in_backward", "true", "--nu_factored", "true")
# kernel wrappers whose launch shapes the phase records: module, name
FSDP_SHAPED = (("fused_attention", "qkv_rope_flash_forward"),
               ("fused_attention", "cross_flash_forward"),
               ("fused_attention", "qkv_rope_flash_backward"),
               ("fused_attention", "cross_flash_backward"),
               ("fused_gelu", "bias_gelu_forward"),
               ("fused_gelu", "bias_gelu_backward"))


def fsdp_config(mesh=(1, 1, 1, 1), flags=()):
    """The canonical training config (with the train CLI's `flags`) on
    `mesh`, without caption dropout (its draws would come from each
    process's global generator)."""
    from video_diffusion_speedrun_tpu_torch.train.__main__ import (
        build_config,
        parse_args,
    )

    r, f, c, t = mesh
    extra = ("--mesh_replica", str(r), "--mesh_fsdp", str(f),
             "--mesh_context", str(c), "--mesh_tensor", str(t), *flags)
    cfg = build_config(parse_args(train_argv(T_DEPTH, extra=extra)))
    return dataclasses.replace(cfg, caption_dropout=0.0)


def fsdp_batches(dev, cfg, steps: int):
    """`steps` global batches of the canonical cell with their timesteps
    and noise, drawn from a fixed seed on the card: the same tensors in
    every process."""
    gen = torch.Generator(device=dev).manual_seed(23)
    out = []
    for _ in range(steps):
        lat = torch.randn(T_BATCH, *T_LATENT, generator=gen, device=dev)
        c, t, h, w = T_LATENT  # the loss floor-crops T to whole patches
        out.append({
            "latent": lat,
            "noise": torch.randn(T_BATCH, c, t // 2 * 2, h, w, generator=gen,
                                 device=dev),
            "context": 0.05 * torch.randn(
                T_BATCH, cfg.data.caption_tokens, cfg.data.context_dim,
                generator=gen, device=dev),
            "timesteps": torch.rand(T_BATCH, generator=gen, device=dev),
            "rope_offsets": torch.zeros(3, dtype=torch.int64)})
    return out


def fsdp_trainer(dev, cfg):
    """A Trainer on `cfg.mesh` holding the canonical DiT with its
    zero-initialised layers made random (as one process makes them)."""
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT
    from video_diffusion_speedrun_tpu_torch.parallel.fsdp import (
        load_full_state,
    )
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, device=dev)
    whole = DiT(cfg.model, device=trainer.device,
                init_std_factor=cfg.init_std_factor, seed=cfg.seed)
    randomize_zero_layers(whole, torch.Generator(
        device=trainer.device).manual_seed(1))
    load_full_state(trainer.model, whole.state_dict())
    del whole
    return trainer


def fsdp_steps(trainer, cfg, batches):
    """The train steps (the config's: standard or in-backward) on this data
    shard's rows of `batches`, counters set to 0 just before and read just
    after: (losses, ms per step, step-1 gradients whole as name → fp32
    host tensor, counts)."""
    from video_diffusion_speedrun_tpu_torch.parallel.mesh import (
        local_batch_slice,
    )
    from video_diffusion_speedrun_tpu_torch.train.step import step_for

    train_step = step_for(cfg)
    opt, sh = trainer.opt, trainer.sharding
    local = local_batch_slice(trainer.mesh, T_BATCH)
    lo = trainer.data_rank * local
    grads = {}
    step, update = opt.step, opt.update_group

    def keep(names, gs):
        for n, g in zip(names, gs):
            if g is not None:
                w = g if sh is None else sh.gathered(n, g)
                grads[n] = w.detach().float().cpu()

    def keep_first(gs):
        if not grads:
            keep(opt.names, gs)
        step(gs)

    def keep_first_group(group, gs):
        if opt.count == 0:
            keep([opt.names[i] for i in opt.groups[group]], gs)
        update(group, gs)

    opt.step, opt.update_group = keep_first, keep_first_group
    losses, ms = [], []
    torch.cuda.synchronize()
    reset_counters()
    for glob in batches:
        batch = {k: (v if k == "rope_offsets" else v[lo:lo + local])
                 for k, v in glob.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(trainer.model, opt, batch, None, cfg,
                       trainer.context_parallel, trainer.data_group)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    counts = read_counters()
    opt.step, opt.update_group = step, update
    return losses, ms, grads, counts


def _fsdp_card(backend: str, rank: int) -> torch.device:
    """The card of a train-fsdp rank: gloo ranks share card 0, NCCL rank r
    takes card r."""
    card = 0 if backend == "gloo" else rank
    torch.cuda.set_device(card)
    return torch.device("cuda", card)


def _fsdp_worker(rank: int, world: int, port: int, backend: str, mesh,
                 ref_path: str, out_path: str, flags=(),
                 steps: int = FSDP_STEPS) -> None:
    """One rank of a train-fsdp mesh: gloo ranks share card 0, NCCL rank r
    takes card r. Rank 0 compares the gathered step-1 gradients and the
    losses with the one-process run in `ref_path` and writes the results;
    every rank writes its counts and kernel launch shapes."""
    import importlib
    import os

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    dev = _fsdp_card(backend, rank)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(dev.index or 0), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    shapes = {}
    for mod, name in FSDP_SHAPED:
        module = importlib.import_module(
            f"video_diffusion_speedrun_tpu_torch.ops.{mod}")
        orig = getattr(module, name)

        def record(*a, _orig=orig, _name=name, **k):
            shapes.setdefault(_name, set()).add(tuple(a[0].shape))
            return _orig(*a, **k)

        record.launches = orig.launches
        setattr(module, name, record)
    try:
        cfg = fsdp_config(mesh, flags)
        trainer = fsdp_trainer(dev, cfg)
        batches = fsdp_batches(dev, cfg, steps)
        losses, ms, grads, counts = fsdp_steps(trainer, cfg, batches)
        opt = trainer.opt
        kernels = ([opt._kernel] if opt._kernel is not None
                   else list(opt._group_kernels.values()))
        res = {"losses": losses, "ms": ms, "counts": counts,
               "shapes": {k: sorted(v) for k, v in shapes.items()},
               "adamw_leaves": sum(k.n_leaves for k in kernels),
               "adamw_elems": sum(int(k.numel.sum()) for k in kernels),
               "factored": sum(opt.factored),
               "data_rank": trainer.data_rank,
               "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        if rank == 0:
            ref = torch.load(ref_path)
            res["loss_rel"] = max(abs(a / w - 1) for a, w in
                                  zip(losses, ref["losses"]))
            rel, (worst, worst_rel) = grad_rel_l2(grads, ref["grads"])
            res.update(grad_rel=rel, worst=worst, worst_rel=worst_rel)
        with open(f"{out_path}.{rank}", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_train_fsdp(dev):
    """FSDP2 and tensor parallelism of the canonical DiT (phase 23 of the
    docstring), and the optimizer-in-backward step at fsdp 2. Returns the
    counts of every rank of every mesh."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    def one_process(flags, steps):
        cfg = fsdp_config(flags=flags)
        trainer = fsdp_trainer(dev, cfg)
        batches = fsdp_batches(dev, cfg, steps)
        out = fsdp_steps(trainer, cfg, batches)
        del trainer, batches
        torch.cuda.empty_cache()
        return cfg, out

    cfg, (losses, ms, grads, counts) = one_process((), FSDP_STEPS)
    want = {k: FSDP_STEPS * v for k, v in train_step_launches(T_L).items()}
    if counts != want:
        raise AssertionError(f"one-process launch counts {counts} != {want}")
    log(f"[train-fsdp] one process: losses {losses}, "
        f"{np.median(ms):.2f} ms per step (median)")
    _, (ib_losses, ib_ms, ib_grads, ib_counts) = one_process(
        INLOOP_FLAGS, FSDP_INLOOP_STEPS)
    ib_want = {k: FSDP_INLOOP_STEPS * v for k, v in train_step_launches(
        T_L, adamw=T_DEPTH + 1, factored=2 * T_DEPTH).items()}
    if ib_counts != ib_want:
        raise AssertionError(f"one-process in-backward launch counts "
                             f"{ib_counts} != {ib_want}")
    log(f"[train-fsdp] one process, in-backward with factored ν: losses "
        f"{ib_losses}, {np.median(ib_ms):.2f} ms per step (median)")
    n_cards = torch.cuda.device_count()
    # (backend, world, label, mesh, train CLI flags, steps, reference,
    # counts)
    forms = [("gloo", 2, label, mesh, (), FSDP_STEPS, "ref", want)
             for label, mesh in FSDP_ONE_CARD]
    forms.append(("gloo", 2, *FSDP_INLOOP, INLOOP_FLAGS, FSDP_INLOOP_STEPS,
                  "ref_ib", ib_want))
    log("[train-fsdp] form: 2 processes on card 0 over gloo (NCCL refuses "
        "two ranks on one device; gloo stages every collective through the "
        "host, so these runs check correctness, not time)")
    for cards in (2, 4):
        if n_cards >= cards:
            forms += [("nccl", cards, label, mesh, (), FSDP_STEPS, "ref",
                       want) for label, mesh in FSDP_CARDS[cards]]
        else:
            log(f"[train-fsdp] NCCL over {cards} cards not run: this machine "
                f"has {n_cards} CUDA card(s)")
    width, heads, mlp = (cfg.model.hidden_size, cfg.model.num_heads,
                         cfg.model.mlp_hidden)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        refs = {"ref": (losses, grads), "ref_ib": (ib_losses, ib_grads)}
        for key, (ref_losses, ref_grads) in refs.items():
            torch.save({"losses": ref_losses, "grads": ref_grads},
                       str(Path(tmp) / f"{key}.pt"))
        del grads, ib_grads, refs
        for (backend, world, label, mesh, flags, steps, ref,
             mesh_want) in forms:
            ref_path = str(Path(tmp) / f"{ref}.pt")
            ref_losses = ib_losses if ref == "ref_ib" else losses
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            out = str(Path(tmp) / f"{backend}{world}")
            t0 = time.perf_counter()
            mp.start_processes(
                _fsdp_worker,
                args=(world, port, backend, mesh, ref_path, out, flags,
                      steps),
                nprocs=world, start_method="spawn")
            wall = time.perf_counter() - t0
            res = [json.loads(Path(f"{out}.{r}").read_text())
                   for r in range(world)]
            tag = f"[train-fsdp] {backend} {label}"
            r0 = res[0]
            ok = (r0["loss_rel"] <= TRAIN_LOSS_REL
                  and r0["grad_rel"] <= TRAIN_GRAD_REL_L2
                  and r0["worst_rel"] <= TRAIN_GRAD_REL_L2)
            log(f"{tag}: {world} ranks, {wall:.1f} s; losses "
                f"{r0['losses']} against one process's {ref_losses}: "
                f"relative {r0['loss_rel']:.3e} (tol {TRAIN_LOSS_REL}); "
                f"step-1 gradient relative L2 {r0['grad_rel']:.3e}, worst "
                f"tensor {r0['worst']} {r0['worst_rel']:.3e} (tol "
                f"{TRAIN_GRAD_REL_L2} each) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("sharded training and one-process "
                                     "training disagree")
            t = mesh[3]
            local = {"qkv_rope_flash_forward": 3 * width // t,
                     "qkv_rope_flash_backward": 3 * width // t,
                     "cross_flash_forward": width // t,
                     "cross_flash_backward": width // t,
                     "bias_gelu_forward": mlp // t,
                     "bias_gelu_backward": mlp // t}
            for r, rr in enumerate(res):
                widths = {k: sorted({sh[-1] for sh in v})
                          for k, v in rr["shapes"].items()}
                if rr["counts"] != mesh_want:
                    raise AssertionError(f"{tag} rank {r}: launch counts "
                                         f"{rr['counts']} != {mesh_want}")
                if widths != {k: [w] for k, w in local.items()}:
                    raise AssertionError(f"{tag} rank {r}: kernels "
                                         f"launched at widths {widths}, "
                                         f"want {local}")
                log(f"{tag} rank {r} (data rank {rr['data_rank']}): "
                    f"{np.median(rr['ms']):.2f} ms per step (median), "
                    f"peak {rr['peak_gb']:.2f} GB; launches as one "
                    f"process; kernel launch shapes {rr['shapes']} "
                    f"({heads // t} of {heads} heads, {mlp // t} of {mlp} "
                    f"MLP columns); AdamW over {rr['adamw_leaves']} local "
                    f"leaves, {rr['adamw_elems'] / 1e6:.2f} M elements"
                    + (f"; {rr['factored']} leaves with factored ν"
                       if rr["factored"] else ""))
                runs.append(rr["counts"])
    return runs


def main_train_mesh(argv) -> int:
    """`[torchrun --nproc_per_node N] chip_smoke.py --train-mesh STEPS
    [--latent C,T,H,W] FLAGS...`: the train CLI's config of FLAGS (its own
    `parse_args` / `build_config`, the mesh from `--mesh_*` over the
    processes torchrun starts) through `Trainer`, its batch stream and
    `train_step`: STEPS steps between synchronisations, then one profiled
    step. Rank 0 prints one JSON line: ms per step (median of steps 2 on),
    the profiled step's wall and device busy ms on rank 0 (by kind;
    communication kernels count as busy), the peak memory of every card,
    the card's name and power limit."""
    import os

    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from video_diffusion_speedrun_tpu_torch.core.config import resolve_device
    from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh
    from video_diffusion_speedrun_tpu_torch.train.__main__ import (
        build_config,
        parse_args,
    )
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer
    from video_diffusion_speedrun_tpu_torch.train.step import step_for

    steps, flags = int(argv[0]), list(argv[1:])
    latent = T_LATENT
    if flags[:1] == ["--latent"]:
        latent = tuple(int(n) for n in flags[1].split(","))
        flags = flags[2:]
    args = parse_args(flags)
    cfg = build_config(args)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, synthetic_shape=latent))
    dev = pmesh.init_distributed(resolve_device(args.device))
    trainer = Trainer(cfg, device=dev)
    train_step = step_for(cfg)  # or the optimizer-in-backward step
    main = pmesh.global_rank() == 0
    tag = f"train-mesh {pmesh.world_size()} x {cfg.mesh}"
    loader = trainer.batches("train")
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for _ in range(steps):
        batch = next(loader)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(trainer.model, trainer.opt, batch, trainer.generator,
                       cfg, trainer.context_parallel, trainer.data_group)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"non-finite loss at step {len(ms)}")
    batch = next(loader)
    prof = profile_device(lambda: train_step(
        trainer.model, trainer.opt, batch, trainer.generator, cfg,
        trainer.context_parallel, trainer.data_group), "one train step",
        tag, rows=12 if main else 0)
    peak = torch.tensor([torch.cuda.max_memory_allocated(dev) / 1e9],
                        device=dev)
    peaks = [peak]
    if pmesh.world_size() > 1:
        peaks = [torch.empty_like(peak) for _ in range(pmesh.world_size())]
        dist.all_gather(peaks, peak)
    loader.close()
    if main:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        wall, busy, kinds = prof if prof else (None, None, {})
        print(json.dumps({
            "world": pmesh.world_size(), "mesh": dataclasses.asdict(
                cfg.mesh.resolve(pmesh.world_size())),
            "batch": cfg.batch_size, "latent": list(latent),
            "params_m": trainer.n_params / 1e6, "steps_ms": ms,
            "ms": float(np.median(ms[2:] or ms)), "profiled_wall_ms": wall,
            "busy_ms": busy, "busy_by_kind": kinds,
            "peak_gb": [float(p) for p in peaks], "card": smi,
            "torch": torch.__version__}), flush=True)
    pmesh.shutdown()
    return 0


# ---- A/B of two checkouts on one card: `python3 chip_smoke.py --ab A B` ----

def rel_l2(got, want) -> float:
    """‖got − want‖ / ‖want‖ in fp32 on the host."""
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).norm() / want.norm()).item()


def decoder_conv_flops(cfg, latent_shape) -> float:
    """Conv FLOPs (2 per multiply-add) of one `CosmosDecoder(cfg)` call on
    a latent of `latent_shape`, counted on the meta device from each
    causal conv's output shape."""
    from video_diffusion_speedrun_tpu_torch.models import cosmos_vae as cv

    model = cv.CosmosDecoder(cfg, device="meta")
    total = [0.0]

    def count(mod, _, out):
        w = mod.conv3d.weight
        total[0] += 2.0 * out.numel() * w[0].numel()

    for mod in model.modules():
        if isinstance(mod, cv.CausalConv3d):
            mod.register_forward_hook(count)
    model(torch.empty(latent_shape, device="meta"))
    return total[0]


def t5_flops(cfg, tokens: int) -> float:
    """Matmul FLOPs of one T5 encode of `tokens` tokens."""
    d, inner, f = cfg.d_model, cfg.inner_dim, cfg.d_ff
    proj = 2 * tokens * d * inner * 4 + 2 * tokens * d * f * 3
    attn = 2 * 2 * cfg.num_heads * tokens * tokens * cfg.d_kv
    return float(cfg.num_layers * (proj + attn))


def group_norm_moments(x, norm):
    """The per-frame group norm with explicit fp32 moments over a [B, g,
    c/g, T, H·W] view (the JAX expression): the alternative timed against
    the port's `F.group_norm` over [B·T, C, H, W]."""
    b, c, t, h, w = x.shape
    g = norm.num_groups
    xf = x.float().view(b, g, c // g, t, h * w)
    var, mean = torch.var_mean(xf, dim=(2, 4), unbiased=False, keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + norm.eps)).view(b, c, t, h, w)
    return (xf * norm.weight.float().view(1, c, 1, 1, 1)
            + norm.bias.float().view(1, c, 1, 1, 1)).to(x.dtype)


def upsample_interpolate(x):
    """Nearest ×2 in T, H and W by `F.interpolate` (the alternative timed
    against the port's broadcast copy), the first frame dropped."""
    _, _, t, h, w = x.shape
    return torch.nn.functional.interpolate(
        x, size=(2 * t, 2 * h, 2 * w), mode="nearest")[:, :, 1:]


def phase_t2v(dev, serve_long_launches):
    """The text-to-video request through the sampler CLI's `main`: T5-XXL
    and the demo DiT with random weights, T2V_STEPS Euler steps at
    512×512×16, the default Cosmos decoder in chunks of 4, the frames
    written to a temporary directory and read back; counters set to 0 just
    before and read just after (the DiT forwards must launch what
    serve-long's do). Then the steady T5 encode, the decode with and
    without `cudnn.benchmark`, and the two group-norm forms, each timed;
    one decoded chunk profiled. Returns the counts."""
    import shutil
    import tempfile

    from video_diffusion_speedrun_tpu_torch import sample
    from video_diffusion_speedrun_tpu_torch.models import cosmos_vae as cv
    from video_diffusion_speedrun_tpu_torch.sampling.decode import to_frames
    from video_diffusion_speedrun_tpu_torch.text.encoder import smoke_encoder

    out_dir = tempfile.mkdtemp(prefix="t2v-")
    try:
        argv = ["--prompt", T2V_PROMPT, "--smoke_encoder", "xxl",
                "--inference_steps", str(T2V_STEPS), "--height",
                str(LONG_PX), "--width", str(LONG_PX), "--num_latent_frames",
                str(LONG_FRAMES), "--context_dim", str(CTX_DIM),
                "--output", out_dir, "--name", "t2v"]
        report = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counters()
        t0 = time.perf_counter()
        latents = sample.main(argv, report)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = read_counters()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        ctx, video = report["context"], report["video"]
        frames = np.load(Path(report["path"]) / "video.npy")
        want_frames = to_frames(video.float().cpu().numpy())
        step_ms = 1e3 * report["sample_s"] / T2V_STEPS
        log(f"[t2v] T5-XXL encode {1e3 * report['encode_s']:.2f} ms (one "
            f"prompt, 512 tokens, first call); {step_ms:.2f} ms per Euler "
            f"step ({T2V_STEPS} steps at L={LONG_L}, the first's warm-up "
            f"included); decode {report['decode_s']:.2f} s, "
            f"{T2V_FRAMES / report['decode_s']:.2f} frames/s; write "
            f"{report['write_s']:.2f} s ({report['path']}); whole request "
            f"{total_s:.2f} s with the models' set-up; peak memory "
            f"{peak_gb:.2f} GB")
        log(f"[t2v] launches {launches}, serve-long's {serve_long_launches}")
        checks = {
            "context [1, 512, 4096]": tuple(ctx.shape) == (1, CTX_LEN,
                                                           CTX_DIM),
            "latents [1, 16, 16, 64, 64]": tuple(latents.shape) == (
                1, 16, LONG_FRAMES, LONG_PX // 8, LONG_PX // 8),
            "video [3, 61, 512, 512]": tuple(video.shape) == (
                3, T2V_FRAMES, LONG_PX, LONG_PX),
            "finite": all(bool(torch.isfinite(t).all())
                          for t in (ctx, latents, video)),
            "video within [-1, 1]": float(video.float().abs().max()) <= 1.0,
            "frames read back": np.array_equal(frames, want_frames),
            "DiT launches = serve-long's": launches == serve_long_launches,
        }
        log(f"[t2v] checks {checks}")
        if not all(checks.values()):
            raise AssertionError(f"t2v request failed: {checks}")
        del report, video, ctx

        encoder = smoke_encoder("xxl", CTX_DIM, dev)
        enc_ms = cuda_ms(lambda: encoder([T2V_PROMPT]), iters=10, warmup=2)
        flops = t5_flops(encoder.cfg, CTX_LEN)
        bound_ms, by = bound(2 * 4.762e9, flops, 0)
        log(f"[t2v] T5-XXL encode steady {enc_ms:.3f} ms ({flops / 1e12:.2f} "
            f"TFLOP → {flops / enc_ms / 1e9:.1f} TFLOP/s; bound "
            f"{bound_ms:.3f} ms by {by})")
        profile_device(lambda: encoder([T2V_PROMPT]), "one T5-XXL encode "
                       "(1 prompt × 512 tokens)", "t2v-t5", rows=8)
        del encoder
        torch.cuda.empty_cache()

        decoder = sample.load_decoder(None, dev, say=lambda *a: None)
        lat = latents[0].bfloat16()
        first = lat[None, :, :sample.DECODE_CHUNK]
        later = lat[None, :, sample.DECODE_CHUNK - 2:2 * sample.DECODE_CHUNK]
        flops = (decoder_conv_flops(decoder.cfg, first.shape)
                 + 3 * decoder_conv_flops(decoder.cfg, later.shape))

        def decode():
            return cv.decode_video(decoder, lat,
                                   chunk_frames=sample.DECODE_CHUNK)

        times = {}
        for bench in (False, True):
            with torch.backends.cudnn.flags(enabled=True, benchmark=bench):
                for run in ("first", "again"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = decode()
                    torch.cuda.synchronize()
                    times[bench, run] = time.perf_counter() - t0
        log(f"[t2v] decode of 61 frames: {flops / 1e15:.3f} PFLOP of convs "
            f"over 4 chunks; cudnn.benchmark off {times[False, 'first']:.3f}"
            f" / {times[False, 'again']:.3f} s (first / again), on "
            f"{times[True, 'first']:.3f} / {times[True, 'again']:.3f} s → "
            f"{flops / times[True, 'again'] / 1e12:.1f} TFLOP/s")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("non-finite decode")
        with torch.backends.cudnn.flags(enabled=True, benchmark=True):
            profile_device(lambda: decoder(later), "one decoded chunk "
                           "(6 latent frames → 21 frames)", "t2v-decode",
                           rows=10)
        # the largest group norm: 256 channels × 21 frames × 512²
        norm = decoder.decoder.up[0].block[1].norm1.norm
        x = torch.randn(1, norm.num_channels, 21, LONG_PX, LONG_PX,
                        device=dev).bfloat16()
        got = cv.group_norm(x, norm.weight, norm.bias, norm.num_groups,
                            norm.eps)
        alt = group_norm_moments(x, norm)
        gn_ms = cuda_ms(lambda: cv.group_norm(x, norm.weight, norm.bias,
                                              norm.num_groups, norm.eps),
                        iters=5, warmup=1)
        alt_ms = cuda_ms(lambda: group_norm_moments(x, norm), iters=5,
                         warmup=1)
        gn_bound, _ = bound(2 * x.numel() * 2, 0, 0)
        diff = (got.float() - alt.float()).abs().max().item()
        log(f"[t2v] group norm at {tuple(x.shape)} bf16: the port's "
            f"(F.group_norm over a [B·T, C, H, W] permute) {gn_ms:.3f} ms, "
            f"explicit fp32 moments over a [B, g, c/g, T, HW] view "
            f"{alt_ms:.3f} ms, bound {gn_bound:.3f} ms; max |difference| "
            f"{diff:.3e}")
        del got, alt
        # the largest temporal + spatial upsample: level 1's, 512 channels
        # × 11 → 21 frames × 128² → 256²
        up = decoder.decoder.up[1].upsample
        del x
        x = torch.randn(1, up.conv.conv3d.in_channels, 11, LONG_PX // 4,
                        LONG_PX // 4, device=dev).bfloat16()
        mine, alt = up(x), up.conv(upsample_interpolate(x))
        if not torch.equal(mine, alt):
            raise AssertionError("the upsample forms disagree")
        up_ms = cuda_ms(lambda: up(x), iters=3, warmup=1)
        alt_ms = cuda_ms(lambda: up.conv(upsample_interpolate(x)), iters=3,
                         warmup=1)
        log(f"[t2v] upsample + causal conv {tuple(x.shape)} → "
            f"{tuple(mine.shape)}: the port's broadcast copy {up_ms:.3f} ms, "
            f"F.interpolate {alt_ms:.3f} ms; the same outputs")
        del x, mine, alt, decoder, out
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def phase_t2v_parity(dev):
    """The request's parts at full width and depth 2, card (bf16) against
    the CPU (fp32) on the same weights: T5 at XXL width with 2 layers on
    the prompt, 2 Euler steps of the demo DiT at depth 2 on that context
    (64×64, 4 latent frames), the default decoder on the result, and the
    decoder alone on 3 latent frames of 16×16."""
    import dataclasses as dc

    from video_diffusion_speedrun_tpu_torch.models.cosmos_vae import (
        CosmosDecoder,
        CosmosDecoderConfig,
        decode_video,
    )
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT
    from video_diffusion_speedrun_tpu_torch.sample import demo_config
    from video_diffusion_speedrun_tpu_torch.sampling.euler import (
        euler_cfg_sample,
    )
    from video_diffusion_speedrun_tpu_torch.text.encoder import (
        ByteFallbackTokenizer,
        PromptEncoder,
    )
    from video_diffusion_speedrun_tpu_torch.text.t5 import (
        T5Config,
        T5Encoder,
        init_t5,
    )

    t0 = time.perf_counter()
    t5cfg = dc.replace(T5Config.xxl(), num_layers=2)
    t5_cpu = init_t5(dc.replace(t5cfg, compute_dtype=torch.float32),
                     device="cpu", generator=torch.Generator().manual_seed(0))
    t5_card = T5Encoder(t5cfg, device=dev, dtype=torch.bfloat16)
    t5_card.load_state_dict(t5_cpu.state_dict())
    ctx_cpu = PromptEncoder(t5_cpu, ByteFallbackTokenizer())([T2V_PROMPT])
    ctx_card = PromptEncoder(t5_card, ByteFallbackTokenizer())([T2V_PROMPT])
    del t5_cpu, t5_card

    cpu_model = DiT(demo_config(WIDTH, 2, HEAD_DIM, CTX_DIM,
                                compute_dtype=torch.float32,
                                attention_impl="fused", fused_adaln="fused"),
                    device="cpu", init_std_factor=0.1, seed=0)
    randomize_zero_layers(cpu_model, torch.Generator().manual_seed(1))
    card_model = DiT(demo_config(WIDTH, 2, HEAD_DIM, CTX_DIM,
                                 param_dtype=torch.bfloat16), device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.standard_normal((1, 16, 4, 8, 8),
                                                 np.float32)).bfloat16()
    lat_cpu = euler_cfg_sample(cpu_model, noise.float(), ctx_cpu,
                               num_steps=2, cfg_scale=6.0)
    lat_card = euler_cfg_sample(card_model, noise.to(dev), ctx_card,
                                num_steps=2, cfg_scale=6.0)
    del cpu_model, card_model

    dec_cpu = CosmosDecoder(CosmosDecoderConfig(compute_dtype=torch.float32),
                            device="cpu", seed=2)
    dec_card = CosmosDecoder(CosmosDecoderConfig(), device=dev)
    dec_card.load_state_dict(dec_cpu.state_dict())
    video_cpu = decode_video(dec_cpu, lat_cpu[0], chunk_frames=4)
    video_card = decode_video(dec_card, lat_card[0].bfloat16(),
                              chunk_frames=4)
    z = torch.from_numpy(rng.standard_normal((1, 16, 3, 16, 16), np.float32))
    dec_rel = rel_l2(dec_card(z.to(dev)), dec_cpu(z))
    rels = {"T5 (XXL width, 2 layers, 512 tokens)":
            (rel_l2(ctx_card, ctx_cpu), T2V_T5_REL_L2),
            "decoder (full width, 3 latent frames of 16×16 → 9 of 128²)":
            (dec_rel, T2V_DECODE_REL_L2),
            "whole request (T5 → 2 Euler steps, DiT depth 2 → decode of "
            "4 latent frames → 13 of 64²)":
            (rel_l2(video_card, video_cpu), T2V_REQUEST_REL_L2)}
    ok = all(r <= tol for r, tol in rels.values()) and bool(
        torch.isfinite(video_card).all())
    for what, (r, tol) in rels.items():
        log(f"[t2v-parity] {what}: relative L2 card vs CPU {r:.3e} (tol "
            f"{tol})")
    log(f"[t2v-parity] latent update relative L2 "
        f"{rel_l2(lat_card - noise.to(dev).float(), lat_cpu - noise.float()):.3e}; "
        f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("card and CPU text-to-video disagree")


def phase_train_t5(dev):
    """T5_TRAIN_STEPS steps of the canonical DiT (batch 64, L = 528) with
    `--use_t5 true --smoke_encoder xxl`: each batch's context is T5-XXL's
    encoding (random weights) of its 64 captions at `--return_index` -8,
    re-encoded every step; the encode timed beside the step. Returns the
    counts (the train steps' own) and the median T5 ms of the steps after
    the first."""
    from video_diffusion_speedrun_tpu_torch.text.encoder import smoke_encoder

    encoder = TimedEncoder(smoke_encoder("xxl", CTX_DIM, dev))
    launches = phase_train(dev, T_BATCH, T_LATENT, T5_TRAIN_STEPS,
                           ("--use_t5", "true", "--smoke_encoder", "xxl"),
                           "train-t5", evaluate=False,
                           prompt_encoder=encoder)[0]
    profile_device(lambda: encoder.encoder([T2V_PROMPT] * T_BATCH,
                                           return_index=-8),
                   f"one T5-XXL encode of a batch ({T_BATCH} × 512 tokens)",
                   "train-t5-encode", rows=8)
    t5_ms = float(np.median(encoder.ms[1:T5_TRAIN_STEPS]))
    del encoder
    torch.cuda.empty_cache()
    return launches, t5_ms


class WidenedOnHost:
    """Rows of a precomputed-embedding join with the context widened to
    fp32 on the host, as the JAX package's join gives them: the loader's
    yardstick in train-real."""

    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        row = self.rows[idx]
        row["context"] = row["context"].float()
        return row


def phase_train_real(dev, train_ms: float, t5_ms: float):
    """The real-data path as a user runs it, at the canonical training
    configuration: a parquet fixture of the dataset's columns
    (`data/fixture.py`), both splits' T5-XXL embeddings (random weights,
    hidden state -8) precomputed with `data/precompute.py`, then the train
    CLI's `main` with `--dataset cosmos_openvid --hf_name … --embeddings_dir
    …`. Timed: the precompute per 64 captions (against train-t5's
    re-encode, `t5_ms`), each train step between synchronisations (against
    the synthetic `train` phase's `train_ms`), the training thread's wait
    for each batch, the loader alone (rows/s), `load_tensor` per row.
    Checks: finite losses, the first device batch equal bit for bit to the
    host rows it was made from, the JAX metric keys in `metrics.jsonl`, the
    launches. Returns the counts of the CLI's run."""
    import shutil
    import tempfile

    from video_diffusion_speedrun_tpu_torch.data import fixture, precompute
    from video_diffusion_speedrun_tpu_torch.data.dataset import (
        LatentDataset,
    )
    from video_diffusion_speedrun_tpu_torch.data.embeddings import (
        PrecomputedEmbeddingJoin,
    )
    from video_diffusion_speedrun_tpu_torch.data.loader import (
        DataLoader,
        ShardedSampler,
        device_batches,
    )
    from video_diffusion_speedrun_tpu_torch.data.serialization import (
        load_tensor,
    )
    from video_diffusion_speedrun_tpu_torch.text import encoder as tenc
    from video_diffusion_speedrun_tpu_torch.train import __main__ as cli
    from video_diffusion_speedrun_tpu_torch.train import loop
    from video_diffusion_speedrun_tpu_torch.utils.profiling import train_mfu

    root = Path(tempfile.mkdtemp(prefix="real-"))
    try:
        fx, cache, emb = (str(root / "fixture.parquet"), str(root / "cache"),
                          root / "emb")
        t0 = time.perf_counter()
        fixture.main(["--out", fx, "--rows", str(REAL_ROWS), "--frames",
                      str(T_LATENT[1]), "--height", str(T_LATENT[2]),
                      "--width", str(T_LATENT[3])])
        log(f"[train-real] fixture: {REAL_ROWS} rows of {T_LATENT} bf16 "
            f"in {time.perf_counter() - t0:.2f} s")

        # the precompute, its encodes timed between synchronisations
        enc_ms, enc_rows = [], []
        encode = tenc.precompute_embeddings

        def timed_encode(encoder, captions, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = encode(encoder, captions, **kw)
            enc_ms.append(1e3 * (time.perf_counter() - t0))
            enc_rows.append(len(captions))
            return out

        tenc.precompute_embeddings = timed_encode
        try:
            for split in ("train", "test"):
                t0 = time.perf_counter()
                precompute.main(["--split", split, "--hf_name", fx,
                                 "--cache_dir", cache, "--smoke_encoder",
                                 "xxl", "--out", str(emb / split)])
                log(f"[train-real] precompute {split}: "
                    f"{time.perf_counter() - t0:.2f} s in all (T5-XXL "
                    f"built, {enc_rows[-1]} captions encoded in "
                    f"{enc_ms[-1]:.2f} ms, fp16 shard written)")
        finally:
            tenc.precompute_embeddings = encode
        torch.cuda.empty_cache()
        per64 = [ms * 64 / n for ms, n in zip(enc_ms, enc_rows)]
        shard_gb = sum(f.stat().st_size for f in emb.rglob("*.npy")) / 1e9
        log(f"[train-real] precompute: {per64[0]:.2f} ms per 64 captions "
            f"(train split, first encode), {per64[1]:.2f} (test split) — "
            f"the encode to fp32 on the host; train-t5 re-encodes 64 "
            f"captions in {t5_ms:.2f} ms every step; {shard_gb:.3f} GB of "
            f"fp16 shards")

        # the loader alone and the row decode, on the host's clock
        train_rows = PrecomputedEmbeddingJoin(
            LatentDataset("train", cache, fx), str(emb / "train"), "train")
        blobs = [train_rows.base.dataset[i]["serialized_latent"]
                 for i in range(len(train_rows))]
        t0 = time.perf_counter()
        for blob in blobs:
            load_tensor(blob)
        load_us = 1e6 * (time.perf_counter() - t0) / len(blobs)
        t0 = time.perf_counter()
        for i in range(len(train_rows)):
            train_rows[i]
        row_us = 1e6 * (time.perf_counter() - t0) / len(train_rows)
        sampler = ShardedSampler(len(train_rows), T_BATCH, seed=0)

        def loader_ms(rows):
            """ms a batch through the loader and the staging alone."""
            stream = device_batches(iter(DataLoader(
                rows, sampler, num_workers=8, prefetch=2,
                num_epochs=REAL_LOADER_BATCHES)), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for batch in stream:
                pass
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / REAL_LOADER_BATCHES, \
                batch

        # the context as the rows carry it (fp16), against JAX's join,
        # which widens it to fp32 on the host, in turns
        wide = WidenedOnHost(train_rows)
        turns = [(name, *loader_ms(rows)) for name, rows in (
            ("fp16", train_rows), ("fp32", wide), ("fp32", wide),
            ("fp16", train_rows))]
        ms16 = float(np.median([t[1] for t in turns if t[0] == "fp16"]))
        ms32 = float(np.median([t[1] for t in turns if t[0] == "fp32"]))
        batch = turns[-1][2]
        batch_bytes = sum(v.numel() * v.element_size()
                          for v in batch.values()
                          if isinstance(v, torch.Tensor))
        ctx_bytes = batch["context"].numel() * 2  # fp16, as in the shards
        log(f"[train-real] loader alone ({REAL_LOADER_BATCHES} batches of "
            f"{T_BATCH} rows, 8 readers, every shard in the page cache): "
            f"{ms16:.2f} ms a batch → {1e3 * T_BATCH / ms16:.1f} rows/s "
            f"with the fp16 context; widened to fp32 on the host (JAX's "
            f"join) {ms32:.2f} ms → {1e3 * T_BATCH / ms32:.1f} rows/s; turns "
            f"{[(t[0], round(t[1], 2)) for t in turns]}; load_tensor "
            f"{load_us:.1f} µs a row of {len(blobs[0])} bytes, a joined row "
            f"{row_us:.1f} µs on one thread")
        log(f"[train-real] host bytes per step: {batch_bytes / 1e6:.1f} MB "
            f"cross to the card (latent bf16 "
            f"{batch['latent'].numel() * 2 / 1e6:.1f} MB, context "
            f"{batch['context'].dtype} {ctx_bytes / 1e6:.1f} MB, widened to "
            f"fp32 on the card); the context is read from the shards' pages, "
            f"copied to rows, stacked and pinned: ≈ "
            f"{4 * ctx_bytes / 1e9:.2f} GB of host copies a step")
        if batch["context"].dtype != torch.float16:
            raise AssertionError("the precomputed context left the host "
                                 f"as {batch['context'].dtype}, not fp16")
        del turns, batch

        # the CLI's run, each step and each wait for a batch timed
        step_ms, wait_ms, first, runs = [], [], {}, []
        step_fn, batches_fn = loop.train_step, loop.Trainer.batches

        def timed_step(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step_fn(*args, **kw)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            return m

        def timed_batches(self, split):
            stream = batches_fn(self, split)
            if split != "train":
                yield from stream
                return
            runs.append(self)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(stream)
                    except StopIteration:
                        return
                    wait_ms.append(1e3 * (time.perf_counter() - t0))
                    if not first:
                        first.update({k: v.clone() for k, v in batch.items()})
                    yield batch
            finally:
                stream.close()

        loop.train_step, loop.Trainer.batches = timed_step, timed_batches
        argv = train_argv(T_DEPTH, extra=(
            "--dataset", "cosmos_openvid", "--hf_name", fx, "--cache_dir",
            cache, "--embeddings_dir", str(emb), "--num_epochs",
            str(REAL_STEPS), "--log_every", "1", "--checkpoint_dir",
            str(root / "ckpt"), "--run_name", "real"))
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        try:
            out = cli.main(argv)
        finally:
            loop.train_step, loop.Trainer.batches = step_fn, batches_fn
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_counters()
        trainer = runs[0]
        want = {k: REAL_STEPS * v for k, v in train_step_launches(T_L).items()}
        for k, n in (("short_attention_fwd<rope>", T_DEPTH),
                     ("short_attention_fwd<norope>", T_DEPTH),
                     ("adaln_rms_modulate_fwd", 3 * T_DEPTH + 1),
                     ("bias_gelu_fwd", T_DEPTH)):
            want[k] += n  # the evaluation after step 1: one forward of 40

        # the first device batch against the host rows it was made from
        idx = ShardedSampler(len(train_rows), T_BATCH, seed=0).epoch(0)[0]
        rows = [train_rows[int(i)] for i in idx]
        # the context crosses in fp16 and is widened on the card (exact)
        same = {k: torch.equal(first[k].cpu(),
                               torch.stack([r[k] for r in rows]).to(
                                   first[k].dtype))
                for k in ("latent", "context")}
        records = [json.loads(line) for line in
                   (root / "ckpt" / "real" / "metrics.jsonl").open()]
        train_keys = {"train/diffusion_loss", "train/total_loss",
                      "train/learning_rate_scale", "train/step",
                      *(f"train_binning/{k}" for k in range(10))}
        test_keys = {"test/total_loss", "test/diffusion_loss",
                     *(f"test_binning/{k}" for k in range(10))}
        losses = [r["train/total_loss"] for r in records
                  if "train/step" in r]
        checks = {
            "steps": len(step_ms) == REAL_STEPS == trainer.step,
            "finite losses": bool(np.isfinite(losses).all())
            and len(losses) == REAL_STEPS,
            "first batch bit for bit": all(same.values()),
            "first batch dtypes": (first["latent"].dtype == torch.bfloat16
                                   and first["context"].dtype
                                   == torch.float32),
            "JAX keys": all(train_keys <= set(r) for r in records
                            if "train/step" in r)
            and any("train/avg_step_ms" in r for r in records)
            and sum(test_keys <= set(r) for r in records) == 1,
            "checkpoint": (root / "ckpt" / "real" / "1").is_dir(),
            "launches": launches == want,
        }
        skip = 2
        steady = float(np.median(step_ms[skip:]))
        log(f"[train-real] the CLI: {REAL_STEPS} steps, the evaluation and "
            f"a checkpoint in {run_s:.2f} s (the Trainer and the datasets "
            f"built); losses {[round(x, 5) for x in losses]}, test loss "
            f"{out['test/total_loss']:.5f}")
        mfu = train_mfu(trainer.cfg.model, T_BATCH, *T_LATENT[1:],
                        steady / 1e3)
        log(f"[train-real] {steady:.2f} ms per step (median of steps "
            f"{skip}–{REAL_STEPS - 1}, between synchronisations; the "
            f"synthetic train phase {train_ms:.2f} ms), MFU {mfu:.4f}; "
            f"steps {[round(x, 2) for x in step_ms]}")
        tail = wait_ms[-REAL_TAIL:]
        log(f"[train-real] the training thread's wait for a batch: mean "
            f"{np.mean(wait_ms[1:]):.2f} ms, max {np.max(wait_ms[1:]):.2f} "
            f"ms over batches 1–{len(wait_ms) - 1}; over the last "
            f"{REAL_TAIL} (the queues filled during the evaluation drained) "
            f"mean {np.mean(tail):.2f} ms, max {np.max(tail):.2f} ms; the "
            f"first, with the loader's start, {wait_ms[0]:.2f} ms; each step "
            f"synchronised; waits {[round(x, 2) for x in wait_ms]}")
        log(f"[train-real] launches {launches}, expected {want}")
        log(f"[train-real] checks {checks}")
        if not all(checks.values()):
            raise AssertionError(f"train-real failed: {checks}")
        batch_t = {k: v for k, v in first.items()}
        gen = torch.Generator(device=dev).manual_seed(1)
        profile_device(lambda: step_fn(trainer.model, trainer.opt, batch_t,
                                       gen, trainer.cfg),
                       "one train step on the real data", "train-real-profile",
                       rows=8)
        del trainer, runs, first, batch_t
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_ckpt(dev):
    """Checkpoints of the canonical DiT (batch 64, L = 528) through the
    Trainer: CKPT_STEPS steps at once (counters set to 0 before, read
    after; the evaluation after step 1 saves, as every evaluation does)
    against half of them, a save, a fresh Trainer that resumes from the
    run root and the rest — losses, parameters, moments, update count and
    generator state bit for bit. Then `restore_params_for_inference`
    feeds the sampler CLI (`--checkpoint`, tiny smoke T5, 256×256×8, 2
    steps), whose latents must equal the restored weights' own. Returns
    the continuous run's counts."""
    import shutil
    import tempfile

    from video_diffusion_speedrun_tpu_torch import sample
    from video_diffusion_speedrun_tpu_torch.core.config import (
        SamplingConfig,
    )
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT
    from video_diffusion_speedrun_tpu_torch.sampling.euler import (
        generate_latents,
    )
    from video_diffusion_speedrun_tpu_torch.train.__main__ import (
        build_config,
        parse_args,
    )
    from video_diffusion_speedrun_tpu_torch.train.checkpoint import (
        restore_params_for_inference,
    )
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer

    root = Path(tempfile.mkdtemp(prefix="ckpt-"))
    try:
        def trainer(name, *extra):
            argv = train_argv(T_DEPTH, extra=(
                "--log_every", "1", "--checkpoint_dir", str(root / name),
                *extra))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t = Trainer(build_config(parse_args(argv)), device=dev)
            torch.cuda.synchronize()
            return t, time.perf_counter() - t0

        def losses(t):
            return [r["train/total_loss"] for r in t.history]

        whole, build_s = trainer("whole")
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        whole.train(until=CKPT_STEPS)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        launches = read_counters()
        per_step = train_step_launches(T_L)
        want = {k: CKPT_STEPS * v for k, v in per_step.items()}
        # the evaluation after step 1: one forward of the 40 test rows
        for k, n in (("short_attention_fwd<rope>", T_DEPTH),
                     ("short_attention_fwd<norope>", T_DEPTH),
                     ("adaln_rms_modulate_fwd", 3 * T_DEPTH + 1),
                     ("bias_gelu_fwd", T_DEPTH)):
            want[k] += n

        first, _ = trainer("first")
        first.train(until=CKPT_STEPS // 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = Path(first.save_checkpoint())
        save_s = time.perf_counter() - t0
        size_gb = sum(f.stat().st_size for f in path.rglob("*")
                      if f.is_file()) / 1e9
        first_losses = losses(first)
        del first
        resumed, load_build_s = trainer("again", "--load_checkpoint",
                                        str(path.parent))
        step0 = resumed.step
        resumed.train(until=CKPT_STEPS)
        torch.cuda.synchronize()

        names = [f"param {n}" for n, _ in whole.model.named_parameters()]
        names += [f"m {n}" for n in whole.opt.names]
        names += [f"v {n}" for n in whole.opt.names]

        def tensors(t):
            return ([p.detach() for p in t.model.parameters()] + t.opt.m
                    + t.opt.v)

        differ = [n for n, a, b in zip(names, tensors(whole),
                                       tensors(resumed))
                  if not torch.equal(a, b)]
        checks = {
            "resumed at step": step0 == CKPT_STEPS // 2,
            "losses bit for bit": losses(whole) == first_losses
            + losses(resumed),
            "parameters and moments bit for bit": not differ,
            "generator state": torch.equal(whole.generator.get_state(),
                                           resumed.generator.get_state()),
            "update count": whole.opt.count == resumed.opt.count
            == CKPT_STEPS,
            "launches": launches == want,
        }
        log(f"[ckpt] {CKPT_STEPS} steps at once {whole_s:.2f} s (the "
            f"evaluation and save after step 1 included), losses "
            f"{losses(whole)}; {CKPT_STEPS // 2} steps + save + resume + "
            f"{CKPT_STEPS - step0}: {first_losses} + {losses(resumed)}")
        log(f"[ckpt] save {save_s:.2f} s, {size_gb:.3f} GB on disk "
            f"(parameters, fp32 moments, count, step, generator); a "
            f"Trainer built with --load_checkpoint {load_build_s:.2f} s, "
            f"without {build_s:.2f} s → restore ≈ "
            f"{load_build_s - build_s:.2f} s")
        log(f"[ckpt] launches {launches}, expected {want}")
        log(f"[ckpt] checks {checks}"
            + (f"; first tensors that differ {differ[:5]}" if differ else ""))
        if not all(checks.values()):
            raise AssertionError(f"resume is not the continuous run: "
                                 f"{checks}")
        del whole, resumed
        torch.cuda.empty_cache()

        run = str(path.parent)
        report = {}
        argv = ["--prompt", T2V_PROMPT, "--checkpoint", run,
                "--smoke_encoder", "--model_width", str(T_WIDTH),
                "--model_depth", str(T_DEPTH), "--model_head_dim",
                str(T_HEAD_DIM), "--height", str(HEIGHT), "--width",
                str(WIDTH_PX), "--num_latent_frames", str(FRAMES),
                "--context_dim", str(CTX_DIM), "--inference_steps", "2",
                "--output", str(root / "video"), "--name", "ckpt"]
        lat = sample.main(argv, report)
        mcfg = sample.demo_config(T_WIDTH, T_DEPTH, T_HEAD_DIM, CTX_DIM)
        model = DiT(mcfg, device=dev)
        model.load_state_dict(restore_params_for_inference(run, mcfg))
        want_lat = generate_latents(model, report["context"], SamplingConfig(
            inference_steps=2, height=HEIGHT, width=WIDTH_PX,
            num_latent_frames=FRAMES))
        same = torch.equal(lat, want_lat)
        log(f"[ckpt] the sampler CLI on the step-{CKPT_STEPS // 2} "
            f"checkpoint: latents {tuple(lat.shape)}, video "
            f"{tuple(report['video'].shape)}; equal to the restored weights' "
            f"own sampling: {same}")
        if not same or not bool(torch.isfinite(report["video"]).all()):
            raise AssertionError("the checkpoint did not feed the sampler")
        del model, report
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


AB_PAIRS = 10  # alternated pairs (A B, B A, ...): rows and serve-long
AB_TRAIN_PAIRS = 2  # of which the first this many also run the train steps


def ab_rows(dev):
    """The attention backward rows at the main path's shapes, each timed
    once (`cuda_ms`) through the wrapper of whichever package is first on
    sys.path, after a check against its twin and a second launch: rows 4
    and 5 at the training shapes, row 5 at train-long's cross-attention
    (8208 × 512, B=2), row 7 at L = 8208 and with the kv-bias at the ring
    fallback's 2064² and 4112², row 11 at the train chunk. Logs
    `[ab] <row> <ms> ms` lines."""
    from video_diffusion_speedrun_tpu_torch.models.rope import rope_cos_sin
    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device=dev).manual_seed(5)
    h, d = T_WIDTH // T_HEAD_DIM, T_HEAD_DIM
    hd, scale = h * d, d ** -0.5

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    def row(name, fn, plain):
        got = fn()
        want = plain()
        for x, y in zip(got, want):
            err = (x.float() - y.float()).abs().max().item()
            if not err <= ATTN_BWD_REL * y.float().abs().max().item():
                raise AssertionError(f"{name}: |err| {err} against the twin")
        if not all(torch.equal(a, b) for a, b in zip(got, fn())):
            raise AssertionError(f"{name}: a second launch gives other bits")
        del got, want
        log(f"[ab] {name} {cuda_ms(fn, iters=10, warmup=2):.4f} ms")

    cos, sin = rope_cos_sin(d, 2, 16, 16, torch.tensor([3, 5, 7], device=dev),
                            num_registers=16)
    # q and k strided out of qkv (row 4) or of q and a k/v projection
    for name, b, lq, lk, rope in (("row4", T_BATCH, T_L, T_L, True),
                                  ("row5", T_BATCH, T_L, CTX_LEN, False),
                                  ("row5-8208", 2, LONG_L, CTX_LEN, False)):
        qkv = randn(b, lq, 3 * hd)
        kv = qkv if rope else randn(b, lk, 3 * hd)
        q, k, v = qkv[..., :hd], kv[..., hd:2 * hd], kv[..., 2 * hd:]
        c, s_ = (cos, sin) if rope else (None, None)
        o, lse = fa.short_attention_cuda(q, k, v, c, s_, h, scale)
        args = (q, k, v, c, s_, o, lse, randn(b, lq, hd), h, scale)
        row(name, lambda: fa.short_attention_bwd_cuda(*args),
            lambda: fa.short_attention_bwd_plain(*args))
    q, k, v = long_inputs(dev, gen, 2, LONG_L, LONG_L, h)
    o, lse = fa.long_attention_cuda(q, k, v, h, scale)
    args = (q, k, v, o, lse, randn(*o.shape), h, scale)
    row("row7", lambda: fa.long_attention_bwd_cuda(*args),
        lambda: fa.long_attention_bwd_plain(*args))
    for cp in (4, 2):
        q, k, v, tabs, kbias = ring_inputs(dev, gen, 2, h, LONG_L, cp, 0,
                                           cp - 1)
        q = fa.rotate_flat(q, tabs[0], tabs[1], h)
        k = fa.rotate_flat(k, tabs[2], tabs[3], h)
        o, lse = fa.long_attention_cuda(q, k, v, h, scale, kbias)
        args = (q, k, v, o, lse, randn(*o.shape), h, scale, kbias)
        row(f"row7-bias-{q.shape[1]}",
            lambda: fa.long_attention_bwd_cuda(*args),
            lambda: fa.long_attention_bwd_plain(*args))
    q, k, v, tabs, kbias = ring_inputs(dev, gen, 2, h, LONG_L, 8, 0, 7)
    o, lse = fa.ring_attention_cuda(q, k, v, *tabs, kbias, h, scale)
    args = (q, k, v, *tabs, kbias, o, lse, randn(*o.shape), h, scale)
    row("row11", lambda: fa.ring_attention_bwd_cuda(*args),
        lambda: fa.ring_chunk_bwd_plain(*args))


def ab_fwd_rows(dev):
    """The attention forward rows at the main path's shapes, each timed
    once (`cuda_ms`) through the wrapper of whichever package is first on
    sys.path, after a check against its twin (the kernels line's limits)
    and against a second launch bit for bit: row 1 at 1040² (B=2, H=16)
    and 528² (B=64, H=4); row 2 at 1040×512 and 8208×512 (B=2, H=16) and
    528×512 (B=64, H=4); row 6 at L = 8208 with H=16 and H=4, and with the
    kv-bias at the ring fallback's 4112² (cp = 2, H=16); row 10 at the
    serve chunk (2064², B=2, H=16) and the train chunk (1040², B=2, H=4).
    Logs `[ab] <row> <ms> ms` lines."""
    from video_diffusion_speedrun_tpu_torch.models.rope import rope_cos_sin
    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device=dev).manual_seed(6)
    d, scale = HEAD_DIM, HEAD_DIM ** -0.5
    serve_h, train_h = WIDTH // HEAD_DIM, T_WIDTH // T_HEAD_DIM

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    def row(name, fn, plain, rel):
        """rel: o within rel·max|o| (long and ring rows), else ATTN_TOL."""
        (o, lse), (po, plse) = fn(), plain()
        tol = rel * po.float().abs().max().item() if rel else ATTN_TOL
        err = (o.float() - po.float()).abs().max().item()
        lerr = (lse - plse).abs().max().item()
        if not (err <= tol and lerr <= LSE_TOL):
            raise AssertionError(f"{name}: |err| {err} (o), {lerr} (lse) "
                                 f"against the twin")
        again = fn()
        if not (torch.equal(o, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f"{name}: a second launch gives other bits")
        del o, lse, po, plse, again
        log(f"[ab] {name} {cuda_ms(fn, iters=20, warmup=3):.4f} ms")

    # q, k strided out of qkv (row 1) or q and the context's k/v (row 2)
    for name, b, h, lq, lk, rope in (
            ("row1-1040", 2, serve_h, 1040, 1040, True),
            ("row1-528", T_BATCH, train_h, T_L, T_L, True),
            ("row2-1040", 2, serve_h, 1040, CTX_LEN, False),
            ("row2-8208", 2, serve_h, LONG_L, CTX_LEN, False),
            ("row2-528", T_BATCH, train_h, T_L, CTX_LEN, False)):
        hd = h * d
        qkv = randn(b, lq, 3 * hd)
        if rope:
            q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
            frames = FRAMES // 2 if lq == 1040 else T_LATENT[1] // 2
            cos, sin = rope_cos_sin(d, frames, 16, 16, torch.tensor(
                [3, 5, 7], device=dev), num_registers=16)
        else:
            ckv = randn(b, lk, 2 * hd)
            q, k, v = qkv[..., :hd], ckv[..., :hd], ckv[..., hd:]
            cos = sin = None
        args = (q, k, v, cos, sin, h, scale)
        row(name, lambda: fa.short_attention_cuda(*args),
            lambda: fa.short_attention_plain(*args), 0.0)
    for name, h in (("row6", serve_h), ("row6-h4", train_h)):
        q, k, v = long_inputs(dev, gen, 2, LONG_L, LONG_L, h)
        row(name, lambda: fa.long_attention_cuda(q, k, v, h, scale),
            lambda: fa.long_attention_plain(q, k, v, h, scale), LONG_FWD_REL)
    q, k, v, tabs, kbias = ring_inputs(dev, gen, 2, serve_h, LONG_L, 2, 0, 1)
    q = fa.rotate_flat(q, tabs[0], tabs[1], serve_h)
    k = fa.rotate_flat(k, tabs[2], tabs[3], serve_h)
    row(f"row6-bias-{q.shape[1]}",
        lambda: fa.long_attention_cuda(q, k, v, serve_h, scale, kbias),
        lambda: fa.long_attention_plain(q, k, v, serve_h, scale, kbias),
        LONG_FWD_REL)
    for h, cp in ((serve_h, 4), (train_h, 8)):
        q, k, v, tabs, kbias = ring_inputs(dev, gen, 2, h, LONG_L, cp, 0,
                                           cp - 1)
        args = (q, k, v, *tabs, kbias, h, scale)
        row(f"row10-{q.shape[1]}", lambda: fa.ring_attention_cuda(*args),
            lambda: fa.ring_chunk_plain(*args), LONG_FWD_REL)
    torch.cuda.empty_cache()


def ab_adaln_rows(dev):
    """The AdaLN backward rows at the main path's shapes, each timed once
    (`cuda_ms`) through the wrapper of whichever package is first on
    sys.path, after a check against its twin (the kernels line's limits)
    and against a second launch bit for bit: row 12 at [64, 528, 512] (x
    strided as the final layer passes it) and [2, 8208, 512], row 14 at
    [64, 528, 512], each with γ and without (the main path's case). Logs
    `[ab] <row> <ms> ms` lines."""
    from video_diffusion_speedrun_tpu_torch.ops import fused_adaln as fad

    gen = torch.Generator(device=dev).manual_seed(8)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    def row(name, fn, plain, names, tols):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        for gname, a, w in zip(names, got, want):
            if w is None:
                continue
            rtol, rel, _ = tols[gname]
            err = (a.float() - w.float()).abs()
            lim = rtol * w.float().abs() + rel * w.float().abs().max()
            if not bool((err <= lim).all()):
                raise AssertionError(f"{name}: {gname} |err| "
                                     f"{err.max().item()} against the twin")
        if not all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(got, fn())):
            raise AssertionError(f"{name}: a second launch gives other bits")
        del got, want
        log(f"[ab] {name} {cuda_ms(fn, iters=20, warmup=3):.4f} ms")

    for tag, b, l, strided in (("528", T_BATCH, T_L, True),
                               ("8208", 2, LONG_L, False)):
        d = T_WIDTH
        x = randn(b, l + 16, d)
        x = x[:, 16:] if strided else x[:, :l]
        mod, g = randn(b, 9 * d), randn(b, l, d)
        shift, scale = mod[:, :d], mod[:, d:2 * d]
        for gamma in (torch.randn(d, generator=gen, device=dev), None):
            args = (x, shift, scale, gamma, g)
            row(f"row12-{tag}{'-gamma' if gamma is not None else ''}",
                lambda: fad.adaln_rms_modulate_bwd(*args),
                lambda: fad.adaln_rms_modulate_bwd_plain(*args),
                ADALN_BWD_NAMES, ADALN_BWD_TOLS)
    b, l, d = T_BATCH, T_L, T_WIDTH
    x_new, delta, gx, gy = (randn(b, l, d) for _ in range(4))
    mod = randn(b, 9 * d)
    gate, scale = mod[:, 2 * d:3 * d], mod[:, d:2 * d]
    for gamma in (torch.randn(d, generator=gen, device=dev), None):
        args = (x_new, delta, gate, scale, gamma, gx, gy)
        row(f"row14-528{'-gamma' if gamma is not None else ''}",
            lambda: fad.gated_residual_adaln_bwd(*args),
            lambda: fad.gated_residual_adaln_bwd_plain(*args),
            GR_BWD_NAMES, GR_BWD_TOLS)
    torch.cuda.empty_cache()


def ab_gelu_rows(dev):
    """Row 16, the bias+GELU backward of the MLP's variant (bf16 rows and
    bias), at the main path's shapes, each timed once (`cuda_ms`) through
    the wrapper of whichever package is first on sys.path, after a check
    against its twin (the kernels line's limits, `hold_gelu_bwd`), against
    a second launch bit for bit and on exact inputs bit for bit
    (`hold_gelu_bwd_exact`): the train shape [64, 528, 2048], train-long's
    [2, 8208, 2048], its tensor-parallel columns at t = 2 and 4
    ([64, 528, 1024], [64, 528, 512]) and the XL in-backward step's
    [16, 1040, 8192]. Logs `[ab] <row> <ms> ms` lines."""
    from video_diffusion_speedrun_tpu_torch.ops import fused_gelu as fg

    gen = torch.Generator(device=dev).manual_seed(14)
    for tag, shape in (("528", (T_BATCH, T_L, T_MLP)),
                       ("8208", (2, LONG_L, T_MLP)),
                       ("528-t2", (T_BATCH, T_L, T_MLP // 2)),
                       ("528-t4", (T_BATCH, T_L, T_MLP // 4)),
                       ("xl", XL_GELU)):
        x = (torch.randn(*shape, generator=gen, device=dev) * 3).bfloat16()
        g = torch.randn(*shape, generator=gen, device=dev).bfloat16()
        bias = (torch.randn(shape[-1], generator=gen, device=dev)
                * 0.5).bfloat16()

        def fn():
            return fg.bias_gelu_backward(x, bias, g, fg.BLOCK)

        hold_gelu_bwd(f"row16-{tag}", str(list(shape)), x, bias, g, fg.BLOCK)
        hold_gelu_bwd_exact(f"row16-{tag}", dev, gen, shape, torch.bfloat16)
        torch.cuda.empty_cache()
        log(f"[ab] row16-{tag} {cuda_ms(fn, iters=20, warmup=3):.4f} ms")
    torch.cuda.empty_cache()


def adaln_configs(dev) -> int:
    """`--adaln-configs`: the AdaLN backward's design choices, measured —
    rows 12 and 14 at [64, 528, 512] and row 12 at [2, 8208, 512], with γ
    and without, under the default configuration and others: the ring's
    stages (2, 3, 4 where they fit), 4 consumer warps a CTA (two or three
    CTAs an SM, where 8 warps leave room for one), and the masked loads;
    each checked against its twin first."""
    from video_diffusion_speedrun_tpu_torch.ops import fused_adaln as fad

    gen = torch.Generator(device=dev).manual_seed(9)
    bf = torch.bfloat16
    d = T_WIDTH

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    cases = []
    for b, l in ((T_BATCH, T_L), (2, LONG_L)):
        x, g, mod = randn(b, l, d), randn(b, l, d), randn(b, 9 * d)
        for gamma in (torch.randn(d, generator=gen, device=dev), None):
            cases.append((f"row12 [{b}, {l}, {d}] gamma={gamma is not None}",
                          (x, g, mod[:, d:2 * d], gamma, 1e-6, (bf,) * 3), {},
                          lambda x=x, g=g, mod=mod, gamma=gamma:
                          fad.adaln_rms_modulate_bwd_plain(
                              x, mod[:, :d], mod[:, d:2 * d], gamma, g),
                          (0, 2, 3, 5)))
    x_new, delta, gx, gy = (randn(T_BATCH, T_L, d) for _ in range(4))
    mod = randn(T_BATCH, 9 * d)
    for gamma in (torch.randn(d, generator=gen, device=dev), None):
        cases.append((f"row14 [{T_BATCH}, {T_L}, {d}] gamma={gamma is not None}",
                      (x_new, gy, mod[:, d:2 * d], gamma, 1e-6, (bf,) * 3),
                      dict(gx=gx, delta=delta, gate=mod[:, 2 * d:3 * d]),
                      lambda gamma=gamma: fad.gated_residual_adaln_bwd_plain(
                          x_new, delta, mod[:, 2 * d:3 * d], mod[:, d:2 * d],
                          gamma, gx, gy),
                      (0, 1, 4, 2, 3, 5)))
    for name, args, kw, plain, order in cases:
        want = plain()
        gated = "gx" in kw
        default = fad._bwd_config(d, 2, 2, gated, args[3] is not None, True)
        configs = [("default", None)]
        configs += [(f"8 warps, {st} stages", (fad.C16, 8, st))
                    for st in (2, 3, 4) if (fad.C16, 8, st) != default
                    and fad._bwd_smem(fad.C16, d, 8, st, 2, 2, gated,
                                      args[3] is not None) <= fad._SMEM_LIMIT]
        configs += [("4 warps, 4 stages", (fad.C16, 4, 4)),
                    ("masked loads, 8 warps", (fad.MASKED, 8, 0))]
        for what, cfg in configs:
            got = fad._bwd_cuda(*args, config=cfg, **kw)
            got = [got[i] for i in order]
            torch.cuda.synchronize()
            tols = GR_BWD_TOLS if gated else ADALN_BWD_TOLS
            check_adaln_bwd("adaln_bwd", f"{name} {what}",
                            GR_BWD_NAMES if gated else ADALN_BWD_NAMES, got,
                            want, tols)
            ms = cuda_ms(lambda: fad._bwd_cuda(*args, config=cfg, **kw))
            occ = fad._occupancy.get((args[0].device.index, int(gated),
                                      int(args[3] is not None), 1,
                                      int(gated), *(cfg or default), d))
            log(f"[adaln-configs] {name} {what} {cfg or default}: "
                f"{ms:.4f} ms, {occ} CTA(s) an SM")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


AB_PATTERNS = (
    (r"\[ab\] (\S+) ([0-9.]+) ms", lambda m: (m[1], float(m[2]))),
    (r"\[serve-long\] request 0 seed \d+: .* ([0-9.]+) ms per Euler step",
     lambda m: ("serve-long step ms", float(m[1]))),
    (r"\[serve-long-profile\] one forward: [0-9.]+ ms wall \(profiled\), "
     r"device busy ([0-9.]+) ms",
     lambda m: ("serve-long busy ms", float(m[1]))),
    (r"\[(train|train-long|train-fr)\] steady state ([0-9.]+) ms",
     lambda m: (m[1] + " step ms", float(m[2]))),
    (r"\[(train|train-long|train-fr)-profile\] one train step: [0-9.]+ ms "
     r"wall "
     r"\(profiled\), device busy ([0-9.]+) ms",
     lambda m: (m[1] + " busy ms", float(m[2]))),
)


def ab_child(tree: str, what: str) -> int:
    """One turn of the A/B in a process of its own, with the package of
    `tree` first on sys.path and this file's measurements: `build` its
    kernels; or, for `what` a "+"-joined list, time the backward, forward,
    AdaLN backward and bias+GELU backward `rows`, serve one serve-long
    request (`serve`) and
    run the `train` steps (L = 528, L = 8208 and L = 528 with
    `fused_residual`)."""
    sys.path.insert(0, tree)
    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa

    if not fa.__file__.startswith(tree):
        raise RuntimeError(f"{fa.__file__} is not under {tree}")
    dev = torch.device("cuda")
    phase_build()
    if what == "build":
        return 0
    parts = what.split("+")
    ab_rows(dev)
    ab_fwd_rows(dev)
    ab_adaln_rows(dev)
    ab_gelu_rows(dev)
    if "serve" in parts:
        model, context = build_demo(dev)
        phase_serve(dev, model, context, LONG_PX, LONG_FRAMES, LONG_STEPS,
                    SEEDS[:1], "serve-long")
        del model, context
        torch.cuda.empty_cache()
    if "train" in parts:
        phase_train(dev, T_BATCH, T_LATENT, T_STEPS, (), "train",
                    evaluate=False)
        phase_train(dev, TL_BATCH, TL_LATENT, TL_STEPS,
                    ("--moments_dtype", "bf16"), "train-long", evaluate=False)
        phase_train(dev, T_BATCH, T_LATENT, FR_STEPS, (), "train-fr",
                    evaluate=False, fused_residual=True)
    return 0


def main_ab(argv) -> int:
    """`--ab TREE_A TREE_B [PAIRS [TRAIN_PAIRS [SERVE_PAIRS]]]`: alternate
    the two checkouts (A B, B A, A B, ...) for PAIRS pairs (default
    AB_PAIRS), each turn a process running `ab_child`: the rows, a
    serve-long request in the first SERVE_PAIRS (default all) and the
    train steps in the first TRAIN_PAIRS (default AB_TRAIN_PAIRS); print
    every reading, the medians, the ranges and how many pairs B won, then
    the card's name and power limit."""
    if not 2 <= len(argv) <= 5 or not torch.cuda.is_available():
        print("usage on a card: chip_smoke.py --ab TREE_A TREE_B [PAIRS "
              "[TRAIN_PAIRS [SERVE_PAIRS]]]", file=sys.stderr)
        return 1
    trees = [str(Path(t).resolve()) for t in argv[:2]]
    pairs = int(argv[2]) if len(argv) > 2 else AB_PAIRS
    train_pairs = int(argv[3]) if len(argv) > 3 else AB_TRAIN_PAIRS
    serve_pairs = int(argv[4]) if len(argv) > 4 else pairs
    # build both trees' kernels at once (each into its own build directory)
    builds = [subprocess.Popen([sys.executable, __file__, "--ab-child", t,
                                "build"], stdout=subprocess.DEVNULL)
              for t in trees]
    if any(p.wait() for p in builds):
        return 1
    readings = [dict(), dict()]  # tree → name → [ms per turn]
    for i in range(pairs):
        for idx in ((0, 1) if i % 2 == 0 else (1, 0)):
            parts = (["rows"] + ["serve"] * (i < serve_pairs)
                     + ["train"] * (i < train_pairs))
            cmd = [sys.executable, __file__, "--ab-child", trees[idx],
                   "+".join(parts)]
            run = subprocess.run(cmd, capture_output=True, text=True)
            if run.returncode:
                print(run.stdout[-2000:], run.stderr[-4000:])
                return 1
            for line in run.stdout.splitlines():
                for pat, get in AB_PATTERNS:
                    m = re.search(pat, line)
                    if m:
                        name, ms = get(m)
                        readings[idx].setdefault(name, []).append(ms)
                        print(f"[ab pair {i} {'AB'[idx]}] {name} {ms}",
                              flush=True)
    for name in readings[0]:
        a, b = readings[0][name], readings[1].get(name, [])
        wins = sum(y < x for x, y in zip(a, b))
        ma, mb = np.median(a), np.median(b)
        print(f"[ab] {name}: A median {ma:.4f} ({min(a):.4f}–{max(a):.4f}, "
              f"{len(a)} runs), B median {mb:.4f} "
              f"({min(b):.4f}–{max(b):.4f}), B/A {mb / ma:.3f}, B faster in "
              f"{wins} of {min(len(a), len(b))} pairs", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


def main() -> int:
    # the random-weight encoders ask transformers for local files only;
    # make sure no hub lookup is ever attempted from the card machine
    import os

    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "video_diffusion_speedrun_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    import datasets
    import pyarrow

    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; datasets {datasets.__version__}, "
        f"pyarrow {pyarrow.__version__}, numpy {np.__version__}, "
        f"{os.cpu_count()} CPUs")

    def timed(tag, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log(f"[time] {tag}: {time.perf_counter() - t0:.1f} s")
        return out

    timed("build", phase_build)
    rows = timed("kernels", phase_kernels, dev)
    rows.update(timed("long kernels", long_attention_rows, dev))
    rows.update(timed("epilogue kernels", epilogue_rows, dev))
    rows.update(timed("ring kernels", ring_attention_rows, dev))
    rows.update(timed("hyvideo kernels", hyvideo_rows, dev))
    runs = []  # the counts of each main-path run
    model, context = build_demo(dev)
    runs.append(timed("serve", phase_serve, dev, model, context, HEIGHT,
                      FRAMES, STEPS, SEEDS, "serve")[0])
    runs.append(timed("serve-long", phase_serve, dev, model, context,
                      LONG_PX, LONG_FRAMES, LONG_STEPS, SEEDS[:1],
                      "serve-long")[0])
    serve_long = runs[-1]
    runs += timed("serve-cp", phase_serve_cp, dev, model, context)
    del model
    torch.cuda.empty_cache()
    model, context = build_demo(dev, fused_residual=True)
    runs.append(timed("serve-fr", phase_serve, dev, model, context, HEIGHT,
                      FRAMES, STEPS, SEEDS, "serve-fr")[0])
    del model
    torch.cuda.empty_cache()
    runs.append(timed("hyvideo", phase_hyvideo, dev))
    runs.append(timed("t2v", phase_t2v, dev, serve_long))
    timed("t2v-parity", phase_t2v_parity, dev)
    timed("parity", phase_parity, dev, FRAMES, "parity")
    timed("long-parity", phase_parity, dev, LP_FRAMES, "long-parity")
    timed("parity-fr", phase_parity, dev, FRAMES, "parity-fr",
          fused_residual=True)
    timed("cp-parity", phase_parity, dev, LP_FRAMES, "cp-parity",
          cp=CP_PARITY)
    train = timed("train", phase_train, dev, T_BATCH, T_LATENT, T_STEPS, (),
                  "train", evaluate=True)
    runs.append(train[0])
    runs.append(timed("train-long", phase_train, dev, TL_BATCH, TL_LATENT,
                      TL_STEPS, ("--moments_dtype", "bf16"), "train-long",
                      evaluate=False)[0])
    runs += timed("train-cp", phase_train_cp, dev)
    runs += timed("train-fsdp", phase_train_fsdp, dev)
    runs += timed("train-inloop", phase_train_inloop, dev)
    timed("inloop-parity", phase_inloop_parity, dev)
    runs += timed("train-remat", phase_train_remat, dev)
    runs.append(timed("train-fr", phase_train, dev, T_BATCH, T_LATENT,
                      FR_STEPS, (), "train-fr", evaluate=False,
                      fused_residual=True)[0])
    runs.append(timed("ckpt", phase_ckpt, dev))
    launches, t5_ms = timed("train-t5", phase_train_t5, dev)
    runs.append(launches)
    runs.append(timed("train-real", phase_train_real, dev, train[3], t5_ms))
    timed("train-parity", phase_train_parity, dev, T_WIDTH, T_LATENT, 4,
          "train-parity")
    timed("long-train-parity", phase_train_parity, dev, T_WIDTH, LP_LATENT,
          2, "long-train-parity")
    timed("train-parity-fr", phase_train_parity, dev, T_WIDTH, T_LATENT, 4,
          "train-parity-fr", fused_residual=True)
    timed("cp-train-parity", phase_train_parity, dev, T_WIDTH, T_LATENT, 4,
          "cp-train-parity", cp=CP_PARITY)
    timed("cp-long-train-parity", phase_train_parity, dev, T_WIDTH,
          LP_LATENT, 2, "cp-long-train-parity", cp=CP_PARITY)
    timed("cp-fallback", phase_cp_fallback, dev)
    timed("nccl-ring", phase_nccl_ring, dev)

    launches = {name: sum(r[name] for r in runs) for name in runs[0]}
    kernels = [dict(rows[name], launches=launches[COUNTED_AS.get(name, name)])
               for name in rows]
    unlaunched = [k["name"] for k in kernels if not k["launches"]]
    if unlaunched:
        raise AssertionError(f"kernels the main path never launched: "
                             f"{unlaunched}")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--adaln-configs"]:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            sys.exit(1)
        sys.path.insert(0, str(ROOT))
        phase_build()
        sys.exit(adaln_configs(torch.device("cuda")))
    if sys.argv[1:2] == ["--hyvideo"]:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            sys.exit(1)
        sys.path.insert(0, str(ROOT))
        sys.exit(main_hyvideo())
    if sys.argv[1:2] == ["--ab"]:
        sys.exit(main_ab(sys.argv[2:]))
    if sys.argv[1:2] == ["--train-mesh"]:
        sys.exit(main_train_mesh(sys.argv[2:]))
    if sys.argv[1:2] == ["--ab-child"]:
        sys.exit(ab_child(sys.argv[2], sys.argv[3]))
    sys.exit(main())
