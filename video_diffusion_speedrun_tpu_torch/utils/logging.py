"""Rank-0 logging and the metrics sinks (port of `utils/logging.py`).

A timestamped log on rank 0; metrics to `metrics.jsonl` (one JSON
record per call, with `step` and `time`) and, when asked, to wandb, which
is imported only then.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import torch.distributed as dist


def is_main_process() -> bool:
    """Rank 0 of the process group, or True without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_logger(name: str = "video_diffusion_speedrun_tpu_torch"
                ) -> logging.Logger:
    """The package's logger at INFO. On rank 0 the root logger gets a
    timestamped stream handler unless it has one already (records
    propagate to it, so they are printed once and test capture sees
    them)."""
    if is_main_process():
        logging.basicConfig(
            format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    return logger


class MetricsLogger:
    """`out_dir/metrics.jsonl` and wandb (if asked for and importable);
    does nothing off rank 0. The file opens (to append) at the first
    record after construction or `finish`."""

    def __init__(self, project: str, run_name: str, config: Dict,
                 out_dir: str, use_wandb: bool = False):
        self.enabled = is_main_process()
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self.wandb = None
        self._file = None
        if not self.enabled:
            return
        if use_wandb:
            try:
                import wandb
            except ImportError as e:
                logging.getLogger(__name__).warning("wandb unavailable: %s",
                                                    e)
            else:
                wandb.init(project=project, name=run_name, config=config)
                self.wandb = wandb

    def log(self, metrics: Dict, step: int) -> None:
        if not self.enabled:
            return
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        if self._file is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._file = open(self.path, "a")
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def finish(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self.wandb is not None:
            self.wandb.finish()
            self.wandb = None


class StepTimer:
    """Mean ms per step over each window of `every` ticks; the window
    starts at the first tick, so the first step's set-up never enters a
    mean."""

    def __init__(self, every: int = 10):
        self.every = every
        self._t0: Optional[float] = None
        self._steps = 0
        self._window = 0
        self.avg_ms: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        self._steps += 1
        if self._t0 is None:
            self._t0 = now
            return None
        self._window += 1
        if self._steps % self.every == 0:
            self.avg_ms = (now - self._t0) / self._window * 1000
            self._t0 = now
            self._window = 0
            return self.avg_ms
        return None
