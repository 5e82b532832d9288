"""What the benchmark takes from the program under test
(`video_diffusion_speedrun_tpu_torch`): its kernel builds, its launch
counters and the model built without its own initialisation. Nothing here
is the yardstick; the modes call the program's entry points themselves.
"""

from __future__ import annotations

import importlib
from typing import Dict

import torch

PKG = "video_diffusion_speedrun_tpu_torch"

# the launch counters of the fused ops: name → (module, function, attribute)
COUNTERS = {
    "self_fwd": ("ops.fused_attention", "qkv_rope_flash_forward", "launches"),
    "cross_fwd": ("ops.fused_attention", "cross_flash_forward", "launches"),
    "long_fwd": ("ops.fused_attention", "long_attention_forward", "launches"),
    "self_bwd": ("ops.fused_attention", "qkv_rope_flash_backward",
                 "launches"),
    "cross_bwd": ("ops.fused_attention", "cross_flash_backward", "launches"),
    "long_bwd": ("ops.fused_attention", "long_attention_backward",
                 "launches"),
    "adaln_fwd": ("ops.fused_adaln", "adaln_rms_modulate", "launches"),
    "adaln_bwd": ("ops.fused_adaln", "adaln_rms_modulate_bwd", "launches"),
    "gated_fwd": ("ops.fused_adaln", "gated_residual_adaln", "launches"),
    "gated_bwd": ("ops.fused_adaln", "gated_residual_adaln_bwd", "launches"),
    "gelu_fwd": ("ops.fused_gelu", "bias_gelu_forward", "launches"),
    "gelu_bwd": ("ops.fused_gelu", "bias_gelu_backward", "launches"),
    "adamw": ("ops.fused_adamw", "MultiTensorAdamW", "launches"),
}


def module(name: str):
    return importlib.import_module(f"{PKG}.{name}")


def read_counters() -> Dict[str, int]:
    out = {}
    for key, (mod, fn, attr) in COUNTERS.items():
        out[key] = int(getattr(getattr(module(mod), fn), attr, 0))
    return out


def launches_between(before: Dict[str, int],
                     after: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def build_kernels(device: torch.device) -> None:
    """Every CUDA source of the program, compiled in parallel where its
    build directory lacks it (the first run in a checkout); a no-op
    after."""
    if device.type != "cuda":
        return
    build = module("ops._build")
    build.build(sorted(p.stem for p in build.CSRC.glob("*.cu")))


def dit(cfg, device: torch.device, weights: Dict[str, torch.Tensor]):
    """The program's DiT of `cfg` on `device` holding `weights`, built on
    the meta device so that the program's own initialisation never runs."""
    model = module("models.dit").DiT(cfg, device="meta")
    model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model
