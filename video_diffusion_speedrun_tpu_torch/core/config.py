"""Configuration dataclasses (port of `video_diffusion_speedrun_tpu/core/config.py`).

Only the model and sampler configs are ported here; the training, mesh and
data configs come with the slices that use them. Dtypes are torch dtypes.

Kernel dispatch (`attention_impl`, `fused_adaln`):
  "fused" — the port's fused op: on a CUDA tensor it launches the hand-written
            kernel, on a CPU tensor it runs the op's plain twin;
  "auto"  — "fused" for CUDA tensors, the unfused composition elsewhere;
  "plain" (attention) / "off" (AdaLN) — the unfused composition.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class DiTConfig:
    """Video DiT architecture config (fields as in the JAX `DiTConfig`)."""

    in_channels: int = 16
    patch_size: int = 2
    time_patch_size: int = 2
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    # None disables cross attention entirely
    cross_attn_input_size: Optional[int] = 4096
    residual_v: bool = False
    # gates trainable RMSNorm scales AND q/kv biases (one flag for both)
    train_bias_and_rms: bool = True
    use_rope: bool = True
    num_registers: int = 16

    rope_base: float = 100.0
    rope_max_t: int = 128
    rope_max_h: int = 128
    rope_max_w: int = 128
    # "matched": RoPE positions flattened (h, w, t), the patchify token order;
    # "reference": flattened (t, h, w), the original model's quirk
    rope_order: str = "matched"
    max_tokens_no_rope: int = 2048

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "auto"  # auto | fused | plain
    fused_adaln: str = "auto"  # auto | fused | off

    def __post_init__(self):
        if self.hidden_size % self.num_heads != 0:
            raise ValueError("hidden_size must be divisible by num_heads")
        if self.head_dim % 4 != 0:
            raise ValueError("head_dim must be divisible by 4 for 3D RoPE")
        if self.rope_order not in ("matched", "reference"):
            raise ValueError(f"unknown rope_order: {self.rope_order}")
        if self.attention_impl not in ("auto", "fused", "plain"):
            raise ValueError(f"unknown attention_impl: {self.attention_impl}")
        if self.fused_adaln not in ("auto", "fused", "off"):
            raise ValueError(f"unknown fused_adaln: {self.fused_adaln}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def out_channels(self) -> int:
        return self.in_channels

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def patch_dim(self) -> int:
        """Flattened input-patch feature size, (c, pt, p, p) order."""
        return (self.in_channels * self.time_patch_size * self.patch_size
                * self.patch_size)

    @property
    def out_patch_dim(self) -> int:
        """Flattened output-patch feature size, (p1, p2, p3, c) order."""
        return (self.patch_size * self.patch_size * self.time_patch_size
                * self.out_channels)

    def replace(self, **kw) -> "DiTConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SamplingConfig:
    """Euler+CFG sampler config."""

    inference_steps: int = 50
    cfg_scale: float = 6.0
    height: int = 512
    width: int = 512
    num_latent_frames: int = 16
    seed: int = 42
    time_shift_alpha: float = 8.0


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device with no card present
    raises here instead of failing later inside an allocation."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device
