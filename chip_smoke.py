#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which raises on failure:

1. build   — compile the CUDA kernels from `video_diffusion_speedrun_tpu_torch/
             csrc/` (one nvcc per source, in parallel) and print ptxas's
             register/shared-memory summary;
2. kernels — hold each kernel against its plain twin on the card, at the
             sampling shapes (self-attention B=2, L=1040, H=16, D=128;
             cross-attention Lk=512; AdaLN D=2048) and at a ragged shape
             (L=333, Lk=77); time kernel, twin, and a library call as a
             yardstick; compute each kernel's bound from the card's peaks;
3. serve   — sample 2 requests (two seeds, 8 Euler steps, CFG 6.0) with the
             demo DiT (width 2048, depth 24, head 128) at 256×256×8 frames
             through `generate_latents`, the launch counters set to 0 just
             before and read just after; profile one Euler step;
4. parity  — the same model at depth 2 and full width, 2 Euler steps on the
             card against the CPU run of the fused ops' twins in fp32.

The next-to-last lines are the kernels JSON and the card's name and power
limit; the last line is {"ok": true, "device": {...}}. With no card, or
outside a checkout, it exits non-zero before printing any result.
"""

import json
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
            elif "Used" in line or "spill" in line:
                log("[build]     " + line.strip())


def attention_case(dev, lq, lk, rope, gen):
    from video_diffusion_speedrun_tpu_torch.models.rope import rope_cos_sin

    h, d = WIDTH // HEAD_DIM, HEAD_DIM
    hd = h * d

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    qkv = randn(2, lq, 3 * hd)
    if rope:
        v = randn(2, lq, hd)
        q, k = qkv[..., :hd], qkv[..., hd:2 * hd]
        gh = gw = int(round(((lq - 16) / (FRAMES // 2)) ** 0.5))
        if (FRAMES // 2) * gh * gw + 16 == lq:
            grid = (FRAMES // 2, gh, gw)
        else:  # ragged: tokens on one axis
            grid = (1, 1, lq - 16)
        cos, sin = rope_cos_sin(d, *grid, torch.tensor([3, 5, 7], device=dev),
                                num_registers=16)
    else:
        ckv = randn(2, lk, 2 * hd)
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
    for rope, name, replaces in (
            (True, "short_attention_fwd<rope>",
             "video_diffusion_speedrun_tpu/ops/fused_attention.py:813"),
            (False, "short_attention_fwd<norope>",
             "video_diffusion_speedrun_tpu/ops/fused_attention.py:757")):
        for lq, lk in ((real_l, real_l if rope else CTX_LEN), (333, 333 if rope else 77)):
            q, k, v, cos, sin, h, d = attention_case(dev, lq, lk, rope, gen)
            scale = d ** -0.5
            o, lse = fa.short_attention_cuda(q, k, v, cos, sin, h, scale)
            po, plse = fa.short_attention_plain(q, k, v, cos, sin, h, scale)
            torch.cuda.synchronize()
            err = (o.float() - po.float()).abs().max().item()
            lerr = (lse - plse).abs().max().item()
            ok = err <= ATTN_TOL and lerr <= LSE_TOL
            log(f"[kernels] {name} Lq={lq} Lk={lk}: max_abs_err(o) {err:.3e} "
                f"(tol {ATTN_TOL}), max_abs_err(lse) {lerr:.3e} "
                f"(tol {LSE_TOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its twin")
            if lq != real_l:
                continue
            ms = cuda_ms(lambda: fa.short_attention_cuda(q, k, v, cos, sin, h,
                                                         scale))
            plain_ms = cuda_ms(lambda: fa.short_attention_plain(
                q, k, v, cos, sin, h, scale), iters=10)
            # yardstick only: SDPA on pre-rotated [B, H, L, D] q/k
            qh, kh, vh = (t.reshape(2, -1, h, d).transpose(1, 2).contiguous()
                          for t in (q, k, v))
            if rope:
                qh = fa._rope_rotate(qh.float(), cos, sin).bfloat16()
                kh = fa._rope_rotate(kh.float(), cos, sin).bfloat16()
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            b = 2
            nbytes = 2 * b * (2 * lq + 2 * lk) * h * d + 4 * b * h * lq
            if rope:
                nbytes += 2 * 4 * lq * d // 2
            tc = 4 * b * h * lq * lk * d
            # rotation (3 flops a rotated element) + softmax (~4 a logit)
            fp32 = 4 * b * h * lq * lk + (3 * b * (lq + lk) * h * d if rope else 0)
            bms, by = bound(nbytes, tc, fp32)
            rows[name] = dict(name=name, route="cuda",
                              source="video_diffusion_speedrun_tpu_torch/csrc/"
                                     "short_attention_fwd.cu",
                              replaces=replaces, max_abs_err=err, ms=ms,
                              plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                              library_ms=lib_ms)
            log(f"[kernels] {name} Lq={lq} Lk={lk}: kernel {ms:.4f} ms, "
                f"twin {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
                f"{bms:.4f} ms ({by}), {tc / ms / 1e9:.1f} TFLOP/s")

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
    from video_diffusion_speedrun_tpu_torch.ops import fused_adaln as fad
    from video_diffusion_speedrun_tpu_torch.ops import fused_attention as fa

    return {"short_attention_fwd<rope>": fa.qkv_rope_flash_forward,
            "short_attention_fwd<norope>": fa.cross_flash_forward,
            "adaln_rms_modulate_fwd": fad.adaln_rms_modulate}


def phase_serve(dev):
    from video_diffusion_speedrun_tpu_torch.core.config import SamplingConfig
    from video_diffusion_speedrun_tpu_torch.sample import demo_config
    from video_diffusion_speedrun_tpu_torch.sampling.euler import (
        generate_latents,
    )
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT

    cfg = demo_config(WIDTH, DEPTH, HEAD_DIM, CTX_DIM,
                      param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = DiT(cfg, device=dev, init_std_factor=0.1, seed=0)
    randomize_zero_layers(model, torch.Generator(device=dev).manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"[serve] demo DiT {n_params / 1e9:.3f} B params (bf16) built in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(1)
    context = torch.randn(1, CTX_LEN, CTX_DIM, generator=gen,
                          device=dev).bfloat16() * 0.05

    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters().values():
        fn.launches = 0
    outs, step_ms = [], []
    for seed in SEEDS:
        sampling = SamplingConfig(inference_steps=STEPS, cfg_scale=6.0,
                                  height=HEIGHT, width=WIDTH_PX,
                                  num_latent_frames=FRAMES, seed=seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = generate_latents(model, context, sampling)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0) / STEPS)
        outs.append(lat)
    launches = {name: fn.launches for name, fn in counters().items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    want = {"short_attention_fwd<rope>": len(SEEDS) * STEPS * DEPTH,
            "short_attention_fwd<norope>": len(SEEDS) * STEPS * DEPTH,
            "adaln_rms_modulate_fwd": len(SEEDS) * STEPS * ADALN_PER_FORWARD}
    for i, (seed, lat, ms) in enumerate(zip(SEEDS, outs, step_ms)):
        log(f"[serve] request {i} seed {seed}: latents {tuple(lat.shape)} "
            f"std {lat.std().item():.4f}, {ms:.2f} ms per Euler step "
            f"(one forward at batch 2, L={lat.shape[2] // 2 * 16 * 16 + 16})")
    log(f"[serve] peak memory {peak_gb:.2f} GB; launches {launches}, "
        f"expected {want}")
    expect_shape = (1, 16, FRAMES, HEIGHT // 8, WIDTH_PX // 8)
    for lat in outs:
        if tuple(lat.shape) != expect_shape or not bool(torch.isfinite(lat).all()):
            raise AssertionError(f"bad latents {tuple(lat.shape)}")
    # the sampler moved the noise, and the two requests differ
    for seed, lat in zip(SEEDS, outs):
        g = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.randn(lat.shape, generator=g, device=dev).bfloat16()
        moved = (lat - noise.float()).norm() / noise.float().norm()
        log(f"[serve] seed {seed}: |latents − noise| / |noise| = "
            f"{moved.item():.4f}")
        if not moved.item() > 1e-2:
            raise AssertionError("sampling did not move the latents")
    if torch.equal(outs[0], outs[1]):
        raise AssertionError("two seeds gave the same latents")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    profile_step(model, context, outs[1])
    del model
    torch.cuda.empty_cache()
    return launches


def profile_step(model, context, lat):
    """Device time by kernel over one Euler step (one batch-2 forward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ckv = model.precompute_context_kv(torch.cat([context,
                                                 torch.zeros_like(context)]))
    x2 = torch.cat([lat, lat]).bfloat16()
    t2 = torch.full((2,), 0.5, device=lat.device)
    with torch.no_grad():
        model(x2, None, t2, context_kv=ckv)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x2, None, t2, context_kv=ckv)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    # kernel rows only: an operator's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        log("[profile] the profiler saw no device time: not measured")
        return
    log(f"[profile] one forward: {wall_ms:.2f} ms wall (profiled), device "
        f"busy {total_ms:.2f} ms ({100 * total_ms / wall_ms:.1f}% of wall)")
    for e in events[:14]:
        ms = e.self_device_time_total / 1e3
        log(f"[profile]   {ms:8.3f} ms {100 * ms / total_ms:5.1f}% "
            f"x{e.count:<4d} {e.key[:90]}")


def phase_parity(dev):
    """Depth 2, full width: 2 Euler steps on the card (bf16, kernels)
    against the CPU (fp32, the fused ops' twins), same weights and noise."""
    from video_diffusion_speedrun_tpu_torch.sample import demo_config
    from video_diffusion_speedrun_tpu_torch.sampling.euler import (
        euler_cfg_sample,
    )
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT

    cpu_cfg = demo_config(WIDTH, 2, HEAD_DIM, CTX_DIM,
                          compute_dtype=torch.float32,
                          attention_impl="fused", fused_adaln="fused")
    cpu_model = DiT(cpu_cfg, device="cpu", init_std_factor=0.1, seed=0)
    randomize_zero_layers(cpu_model, torch.Generator().manual_seed(1))
    card_model = DiT(demo_config(WIDTH, 2, HEAD_DIM, CTX_DIM,
                                 param_dtype=torch.bfloat16), device=dev)
    card_model.load_state_dict(cpu_model.state_dict())

    rng = np.random.default_rng(0)
    shape = (1, 16, FRAMES, HEIGHT // 8, WIDTH_PX // 8)
    noise = torch.from_numpy(rng.standard_normal(shape, np.float32)).bfloat16()
    ctx = torch.from_numpy(
        rng.standard_normal((1, CTX_LEN, CTX_DIM), np.float32) * 0.05)
    t0 = time.perf_counter()
    cpu = euler_cfg_sample(cpu_model, noise.float(), ctx, num_steps=2,
                           cfg_scale=6.0)
    cpu_s = time.perf_counter() - t0
    card = euler_cfg_sample(card_model, noise.to(dev), ctx.to(dev).bfloat16(),
                            num_steps=2, cfg_scale=6.0).cpu()
    d_cpu, d_card = cpu - noise.float(), card - noise.float()
    rel = ((d_card - d_cpu).norm() / d_cpu.norm()).item()
    ok = rel <= PARITY_REL_L2 and bool(torch.isfinite(card).all())
    log(f"[parity] depth 2, width {WIDTH}, 2 steps: relative L2 of the "
        f"latent update, card vs CPU {rel:.3e} (tol {PARITY_REL_L2}; CPU "
        f"run {cpu_s:.1f} s) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("card and CPU disagree")


def main() -> int:
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
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    phase_build()
    rows = phase_kernels(dev)
    launches = phase_serve(dev)
    phase_parity(dev)

    kernels = [dict(rows[name], launches=launches[name]) for name in rows]
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
    sys.exit(main())
