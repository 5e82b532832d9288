"""Frozen yardsticks: the chip's peaks, the DiT's FLOP model, and each fused
kernel's least time from its operations and bytes.

Copied here so that a change to the program cannot move them: the FLOP
model is the port's `utils/flops.py` (useful FLOPs, the remat recompute
left out), the kernel bounds are `chip_smoke.py`'s (`bound`,
`attention_bounds`, `adaln_bwd_bound`, `gelu_bwd_bound`), and the kernel
kinds are its `KERNEL_KINDS` table. A configuration is the dict of its
file under `configs/`.
"""

from __future__ import annotations

from math import prod
from typing import Dict, Sequence

# NVIDIA H100 SXM data sheet, dense rates
PEAK_BF16_TC = 989e12  # bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12  # fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": PEAK_BF16_TC}


def bound_s(nbytes: float, tc_flops: float = 0.0,
            fp32_flops: float = 0.0) -> float:
    """The least seconds the chip needs: the larger of bytes over the
    memory bandwidth and operations over their peak."""
    return max(nbytes / PEAK_BYTES, tc_flops / PEAK_BF16_TC,
               fp32_flops / PEAK_FP32)


def tokens(c: Dict, latent: Sequence[int]) -> int:
    """Patch tokens of one latent [C, T, H, W] (registers not counted)."""
    _, t, h, w = latent
    return ((t // c["time_patch_size"]) * (h // c["patch_size"])
            * (w // c["patch_size"]))


def context_kv_flops(c: Dict, batch: int, context_len: int) -> float:
    """The context K/V projections of every block."""
    if not c["cross_attn_input_size"]:
        return 0.0
    d = c["hidden_size"]
    return (batch * c["depth"] * 2 * context_len * c["cross_attn_input_size"]
            * 2 * d)


def dit_forward_flops(c: Dict, batch: int, latent: Sequence[int],
                      context_len: int, with_context_kv: bool = True
                      ) -> float:
    """FLOPs of one DiT forward over `batch` latents [C, T, H, W]."""
    d = c["hidden_size"]
    f = int(d * c["mlp_ratio"])
    l = tokens(c, latent)
    lt = l + c["num_registers"]
    pdim = (c["in_channels"] * c["time_patch_size"] * c["patch_size"] ** 2)
    per_block = (2 * lt * d * 3 * d + 4 * lt * lt * d + 2 * lt * d * d
                 + 4 * lt * d * f + 2 * d * 9 * d)
    if c["cross_attn_input_size"]:
        per_block += 2 * lt * d * d + 4 * lt * context_len * d \
            + 2 * lt * d * d
    total = batch * (2 * l * pdim * d + c["depth"] * per_block
                     + 2 * d * 4 * d * 2 + 2 * l * d * pdim + 2 * d * 2 * d)
    if with_context_kv:
        total += context_kv_flops(c, batch, context_len)
    return total


def dit_train_flops(c: Dict, batch: int, latent: Sequence[int],
                    context_len: int) -> float:
    """Forward and backward, 3× the forward."""
    return 3.0 * dit_forward_flops(c, batch, latent, context_len)


# kernel bounds, seconds per launch

def attention_bound(b: int, h: int, lq: int, lk: int, d: int,
                    backward: bool) -> float:
    """Forward: reads q, k, v, writes o and lse; 4·B·H·Lq·Lk·D tensor
    FLOPs, ~5 fp32 FLOPs a logit. Backward: reads q, k, v, o, do, lse,
    writes dq, dk, dv; 10·B·H·Lq·Lk·D, ~4 fp32 FLOPs a logit (bf16)."""
    hd = h * d
    if not backward:
        return bound_s(2 * b * (2 * lq + 2 * lk) * hd + 4 * b * h * lq,
                       4 * b * h * lq * lk * d, 5 * b * h * lq * lk)
    return bound_s(2 * b * hd * (3 * lq + 2 * lk) + 4 * b * h * lq
                   + 2 * b * hd * (lq + 2 * lk),
                   10 * b * h * lq * lk * d, 4 * b * h * lq * lk)


def adaln_fwd_bound(b: int, l: int, d: int, esize: int = 2) -> float:
    """Row 3: reads x, writes y (shift and scale are [B, D])."""
    return bound_s(2 * b * l * d * esize + 2 * b * d * esize)


def adaln_bwd_bound(b: int, l: int, d: int, esize: int = 2,
                    gamma: bool = False, gated: bool = False) -> float:
    """Row 12 reads x and g, writes dx; row 14 reads x_new, δ, gx, gy and
    writes dx and dδ; both read scale (and gate, γ) and write the [B, D]
    sums (and dγ); ~14 fp32 FLOPs an element (row 14: ~20)."""
    n = b * l * d
    nbytes = (6 if gated else 3) * n * esize + (5 if gated else 3) * b * d * 2
    nbytes += 2 * d * 4 if gamma else 0
    return bound_s(nbytes, 0, (20 if gated else 14) * n)


def gated_fwd_bound(b: int, l: int, d: int, esize: int = 2) -> float:
    """Row 13: reads x and δ, writes x_new and y."""
    return bound_s(4 * b * l * d * esize + 4 * b * d * esize)


def gelu_fwd_bound(shape: Sequence[int], esize: int = 2) -> float:
    """Row 15: reads x (and the bias), writes y."""
    return bound_s(2 * prod(shape) * esize + shape[-1] * esize)


def gelu_bwd_bound(shape: Sequence[int], esize: int = 2) -> float:
    """Row 16: reads x, g and the bias, writes dx and dbias; ~40 fp32
    FLOPs an element."""
    n = prod(shape)
    return bound_s(3 * n * esize + shape[-1] * 2 * esize, 0, 40 * n)


# device kernels by name: (kind, substrings), the first match wins; the
# bias+GELU kind comes before attention, whose "bwd_kernel" would take it
KERNEL_KINDS = (
    ("adaln_bwd", ("adaln_bwd_kernel",)),
    ("bias_gelu", ("bias_gelu",)),
    ("attention", ("short_attention", "long_attention", "fwd_kernel",
                   "bwd_kernel", "dq_store", "dkv_reduce", "prep_q",
                   "prep_k", "rope_rotate")),
    ("adaln_fwd", ("adaln_rms_modulate",)),
    ("gated_residual_fwd", ("gated_residual_adaln",)),
    ("adamw", ("adamw_multi_tensor",)),
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
    ("nccl", ("nccl",)),
    ("elementwise", ("at::native",)),
)
EPILOGUE_KINDS = ("adaln_bwd", "bias_gelu", "adaln_fwd",
                  "gated_residual_fwd")


def kind_of(name: str) -> str:
    for kind, keys in KERNEL_KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"
