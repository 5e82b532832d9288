"""A tiny copy of the benchmark's cells for the CPU: a temporary folder of
configuration, traffic and limits files at a small size, and a copy of
`BENCHMARK.json` that names them, so a test adds cells without editing a
file of the benchmark."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"hidden_size": 64, "depth": 2, "num_heads": 2, "mlp_ratio": 4.0,
        "in_channels": 16, "patch_size": 2, "time_patch_size": 2,
        "num_registers": 16, "cross_attn_input_size": 32, "residual_v": True,
        "train_bias_and_rms": False, "rope_base": 100.0, "rope_max": 128}
LR = ["--learning_rate", "0.015625", "--lr_scheduler_type", "linear",
      "--max_steps", "5004"]
INBWD = ["--optimizer_in_backward", "true", "--nu_factored", "true",
         "--param_dtype", "bf16", "--moments_dtype", "bf16"]
TRAIN = {"mode": "train", "metric": "train_tokens_per_s", "batch": 4,
         "latent": [16, 5, 8, 8],
         "context_tokens": 8, "alpha": 8.0, "train_argv": LR, "pool": 3,
         "check_steps": 3, "trace_steps": 2, "reference_micro_batch": 2}
SAMPLE = {"mode": "sample", "height": 32, "width": 32, "frames": 4,
          "steps": 4, "cfg_scale": 6.0, "alpha": 8.0, "context_tokens": 8,
          "param_dtype": "bf16", "pool": 3, "capture": 2, "check_steps": 2,
          "trace_skip": 1, "trace_steps": 2}
# the tiny cells: name → (traffic, the end-to-end metric it reports)
CELLS = {"tiny-train": ("tiny-standard", "train_tokens_per_s"),
         "tiny-inbwd": ("tiny-inbwd", "train_tokens_per_s"),
         "tiny-sample": ("tiny-sample", "euler_step_ms")}
# loose limits of the tiny cells, by the end-to-end metric they report
LIMITS = {"train_tokens_per_s": {"loss_gap": 0.5, "grad_gap": 0.5,
                                 "update_gap": 0.5},
          "euler_step_ms": {"velocity_gap": 0.5, "trajectory_gap": 0.5}}


class Tiny:
    def __init__(self, root: Path):
        self.dir = root
        for kind in ("configs", "traffic", "limits"):
            (root / kind).mkdir()
        self.write("configs", "tiny", TINY)
        self.write("traffic", "tiny-standard", TRAIN)
        self.write("traffic", "tiny-inbwd",
                   dict(TRAIN, train_argv=LR + INBWD))
        self.write("traffic", "tiny-sample", SAMPLE)
        self.spec = json.loads((ROOT / "BENCHMARK.json").read_text())
        for cell, (traffic, e2e) in CELLS.items():
            self.add_cell(cell, "tiny", traffic, e2e)

    def write(self, kind: str, name: str, data) -> Path:
        path = self.dir / kind / f"{name}.json"
        path.write_text(json.dumps(data))
        return path

    def add_cell(self, cell: str, config: str, traffic: str,
                 e2e: str) -> None:
        """A cell in the spec copy, its limits file, and its name added to
        the metrics that list the cells of `e2e`."""
        self.spec["workloads"].append({"name": cell, "config": config,
                                       "traffic": traffic, "chips": 1,
                                       "why": "a CPU test"})
        self.write("limits", cell, {"limits": LIMITS[e2e]})
        for m in self.spec["end_to_end"] + self.spec["per_layer"]:
            if "workloads" in m and (m["name"] == e2e
                                     or m.get("moves") == e2e):
                m["workloads"].append(cell)

    def run(self, cell: str, trace: bool = False, seed: int = 2 ** 31 + 11,
            **runner_kw):
        from benchmark import harness

        return harness.run_cell(self.spec, cell, seed, 0.2, trace,
                                torch.device("cpu"), time.time(),
                                dirs=(self.dir, harness.HERE),
                                runner_kw=runner_kw)


@pytest.fixture
def tiny(tmp_path) -> Tiny:
    return Tiny(tmp_path)
