"""Device traces and MFU (port of `utils/profiling.py`).

`trace(log_dir)` records the enclosed steps with `torch.profiler` (host
and, on a card, device activity) and writes a Chrome trace under
`log_dir`; `train_mfu` holds a step's time against the FLOP model
(`utils/flops.py`) and the card's bf16 peak.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig
from video_diffusion_speedrun_tpu_torch.utils.flops import (
    dit_train_flops,
    mfu,
)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[
        torch.profiler.profile]]:
    """Profile the enclosed steps into `log_dir/trace-<time>.json`
    (chrome://tracing, Perfetto); no-op when log_dir is None."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{time.time_ns()}.json"))


def train_mfu(cfg: DiTConfig, batch: int, t: int, h: int, w: int,
              step_seconds: float, device_name: Optional[str] = None,
              context_len: int = 512) -> float:
    """MFU of a train step of `batch` latents [C, t, h, w] done in
    `step_seconds` on the process group's cards (named `device_name`, by
    default card 0's)."""
    name = device_name or torch.cuda.get_device_name(0)
    return mfu(dit_train_flops(cfg, batch, t, h, w, context_len),
               step_seconds, name)
