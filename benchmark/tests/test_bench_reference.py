"""The plain reference against the port's CPU path. With the port's compute
dtype set to float32 the two compute the same arithmetic, so the
comparison's numbers fall to float32 rounding: the reference's
architecture, loss, muP-AdamW (standard and in-backward with factored ν)
and sampler are the port's. The parameter names and shapes are the
port's DiT's."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness
from benchmark.reference.dit import param_shapes
from conftest import LR, TRAIN

FP32 = {"compute_dtype": torch.float32}


@pytest.mark.parametrize("config", ["dit-canonical-248m", "dit-demo-2.76b"])
def test_parameters_are_the_ports(config):
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT
    from video_diffusion_speedrun_tpu_torch.sample import demo_config

    c = json.loads((harness.HERE / "configs" / f"{config}.json").read_text())
    cfg = demo_config(c["hidden_size"], c["depth"],
                      c["hidden_size"] // c["num_heads"],
                      c["cross_attn_input_size"])
    port = {n: tuple(p.shape) for n, p in
            DiT(cfg, device="meta").named_parameters()}
    assert port == param_shapes(c)


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-inbwd-fp32",
                                  "tiny-sample-2"])
def test_reference_follows_the_port_in_fp32(tiny, cell):
    if cell == "tiny-inbwd-fp32":
        # in-backward with factored ν on fp32 parameters and moments
        tiny.write("traffic", "inbwd-fp32", dict(
            TRAIN, train_argv=LR + ["--optimizer_in_backward", "true",
                                    "--nu_factored", "true"]))
        tiny.add_cell(cell, "tiny", "inbwd-fp32", "train_tokens_per_s")
    if cell == "tiny-sample-2":
        from conftest import SAMPLE

        tiny.write("traffic", "sample-2", dict(SAMPLE, steps=2,
                                               trace_skip=0, trace_steps=1))
        tiny.add_cell(cell, "tiny", "sample-2", "euler_step_ms")
    out = tiny.run(cell, model_overrides=FP32)
    for name, (value, _) in out["checks"].items():
        assert value < 1e-5, (name, value)


def test_bf16_program_reads_above_fp32_rounding(tiny):
    """The port as configured (bf16 compute) parts from the float32
    reference by more than rounding, and by far less than the loose
    limits of the tiny cells."""
    out = tiny.run("tiny-train")
    assert 1e-6 < max(v for v, _ in out["checks"].values()) < 0.05
