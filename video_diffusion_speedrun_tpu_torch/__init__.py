"""PyTorch/CUDA port of video_diffusion_speedrun_tpu for NVIDIA Hopper.

Subpackages mirror the JAX package (`core/ data/ ops/ models/ sampling/
train/ utils/`) so each module pairs with its reference by path. The port
imports torch only; the JAX package is its numerical reference in the
tests.
"""

from video_diffusion_speedrun_tpu_torch.core.config import (  # noqa: F401
    DiTConfig,
    SamplingConfig,
)
