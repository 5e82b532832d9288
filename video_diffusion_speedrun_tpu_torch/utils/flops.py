"""Model-FLOP accounting for throughput and MFU (port of `utils/flops.py`).

Counts are useful model FLOPs (train ≈ 3× forward); remat recompute counts
as overhead, so MFU is conservative. Peaks are dense bf16 tensor-core
rates by CUDA device name; an unknown card raises rather than borrowing
another card's peak. MFU holds a step against the peak of every card of
the process group (`parallel.mesh.world_size()`, 1 without one): a step
split over n cards by data or context parallelism has n cards' peak.
"""

from __future__ import annotations

from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig
from video_diffusion_speedrun_tpu_torch.parallel.mesh import world_size

# dense bf16 FLOP/s, NVIDIA data sheets
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM
    "NVIDIA H100 PCIe": 756e12,
}


def peak_flops_for(device_name: str) -> float:
    try:
        return PEAK_FLOPS[device_name]
    except KeyError:
        raise KeyError(f"no bf16 peak known for {device_name!r}; add it to "
                       "utils/flops.py:PEAK_FLOPS") from None


def mfu(flops: float, seconds: float, device_name: str) -> float:
    """Model FLOPs utilisation of a step of `flops` (the whole global
    batch's) done in `seconds` on the process group's cards, each named
    `device_name`."""
    return flops / seconds / (world_size() * peak_flops_for(device_name))


def dit_forward_flops(cfg: DiTConfig, batch: int, t: int, h: int, w: int,
                      context_len: int = 512) -> float:
    """FLOPs of one DiT forward at latent shape [batch, C, t, h, w]."""
    d = cfg.hidden_size
    l = (t // cfg.time_patch_size) * (h // cfg.patch_size) * (w // cfg.patch_size)
    l_tot = l + cfg.num_registers
    lc = context_len

    patch = 2 * l * cfg.patch_dim * d
    per_block = (
        2 * l_tot * d * 3 * d          # qkv
        + 4 * l_tot * l_tot * d        # self-attn: QK^T + PV
        + 2 * l_tot * d * d            # attn proj
        + 4 * l_tot * d * cfg.mlp_hidden  # mlp (fc1 + fc2)
        + 2 * d * 9 * d                # adaLN (per sample)
    )
    if cfg.cross_attn_input_size is not None:
        per_block += (
            2 * l_tot * d * d          # q_cross
            + 2 * lc * cfg.cross_attn_input_size * 2 * d  # context kv
            + 4 * l_tot * lc * d       # cross-attn
            + 2 * l_tot * d * d        # cross proj
        )
    time_embed = 2 * d * 4 * d * 2
    final = 2 * l * d * cfg.out_patch_dim + 2 * d * 2 * d
    return batch * (patch + cfg.depth * per_block + time_embed + final)


def dit_train_flops(cfg: DiTConfig, batch: int, t: int, h: int, w: int,
                    context_len: int = 512) -> float:
    """fwd + bwd ≈ 3× fwd (useful FLOPs; excludes remat recompute)."""
    return 3.0 * dit_forward_flops(cfg, batch, t, h, w, context_len)
