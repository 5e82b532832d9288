"""A tiny copy of the HunyuanVideo cell (`hyvideo-sample-544x960x33f-
l18360`) end to end on the CPU: the MM-DiT cut to 2 heads of 128 and
2 + 2 blocks, 3 latent frames of 8×8, 16 text slots, 4 steps. The run's
comparison (`harness.judge`) under the cell's committed limits finds the
program correct, and the control (the reference with float8 products and a
bf16 accumulator) and the planted fault that attends to the padded text
keys incorrect."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import calibrate, counts_hyvideo, harness
from benchmark.modes import sample_hyvideo

CELL = "hyvideo-sample-544x960x33f-l18360"
TINY = {"hidden_size": 256, "heads_num": 2, "mm_double_blocks_depth": 2,
        "mm_single_blocks_depth": 2, "text_states_dim": 64,
        "text_states_dim_2": 32, "text_len": 16}
SMALL = {"height": 64, "width": 64, "frames": 9, "steps": 4,
         "text_slots": 16, "text_valid": [4, 12], "pool": 2,
         "trace_skip": 1, "trace_steps": 1}


@pytest.fixture
def hyv(tiny):
    """The tiny cell `tiny-hyv` in the tiny spec, its limits the real
    cell's, listed by the `.hyvideo` metrics and `euler_step_ms`."""
    spec = tiny.spec
    cell = harness.cell_of(spec, CELL)
    config = harness.load_json(harness.find("configs", cell["config"],
                                            (harness.HERE,)))
    traffic = harness.load_json(harness.find("traffic", cell["traffic"],
                                             (harness.HERE,)))
    tiny.write("configs", "tiny-hyv", dict(config, **TINY))
    tiny.write("traffic", "tiny-hyv", dict(traffic, **SMALL))
    tiny.write("limits", "tiny-hyv", {"limits": harness.limits_of(CELL)})
    spec["workloads"].append({"name": "tiny-hyv", "config": "tiny-hyv",
                              "traffic": "tiny-hyv", "chips": 1,
                              "why": "a CPU test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny-hyv")
    return tiny


@pytest.mark.parametrize("trace", [False, True])
def test_the_tiny_cell_runs_and_is_correct(hyv, trace):
    out = hyv.run("tiny-hyv", trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == {"velocity_gap", "padding_gap", "text_gap",
                                  "trajectory_gap"}
    assert out["checks"]["padding_gap"][0] == 0.0
    if trace:  # no device: the device readers find nothing to read
        assert out["metrics"] == {}
    else:
        assert set(out["metrics"]) == {"euler_step_ms", "peak_mem_gb",
                                       "setup_s"}


def test_the_control_and_the_padded_keys_are_incorrect(hyv):
    cpu = torch.device("cpu")
    dirs = (hyv.dir, harness.HERE)
    limits = harness.limits_of(CELL)
    got = calibrate.readings(hyv.spec, "tiny-hyv", 2 ** 31 + 29, "control",
                             cpu, dirs=dirs)
    assert calibrate.judged(got, limits) == {"control": False}, got
    out = hyv.run("tiny-hyv", fault="padded_keys")
    assert not out["correct"], out["checks"]
    assert out["checks"]["padding_gap"][0] > 1e-3


def test_the_flop_model_counts_the_published_layers():
    """At the cell's shapes, 13.59 GFLOP a token in the blocks' linear
    layers and 4·L²·D a block in attention, as the cell's reckoning has
    it; the once-a-request work under a thousandth of a step."""
    c = json.loads((harness.HERE / "configs" /
                    "hunyuanvideo-t2v-13b.json").read_text())
    n_img, n_txt = 18360, 160
    l = n_img + n_txt
    d = c["hidden_size"]
    linear = 60 * 24 * d * d * l
    attention = 60 * 4 * l * l * d
    step = counts_hyvideo.step_flops(c, n_img, n_txt)
    assert linear / l == pytest.approx(13.59e9, rel=1e-3)
    assert 1 < step / (linear + attention) < 1.005
    assert counts_hyvideo.request_flops(c, n_txt) < 1e-3 * step


def test_text_lengths_are_uniform_and_cover_the_range():
    """Each request's valid length lies in the traffic's range, one in each
    quarter of it for a pool of 4, and over many seeds each request's
    length spreads over the whole range."""
    t = json.loads((harness.HERE / "traffic" /
                    "hyv-t2v-544x960x33f.json").read_text())
    lo, hi = t["text_valid"]
    span = hi - lo + 1
    firsts = []
    for seed in range(2 ** 31 + 1, 2 ** 31 + 401):
        n = sample_hyvideo.text_lengths(t, seed, 4)
        for q, x in enumerate(sorted(n)):
            assert lo + span * q // 4 <= x <= lo + span * (q + 1) // 4
        assert n == sample_hyvideo.text_lengths(t, seed, 4)
        firsts.append(n[0])
    assert min(firsts) < lo + 10 and max(firsts) > hi - 10
    assert [sum((x - lo) * 4 // span == q for x in firsts)
            for q in range(4)] == pytest.approx([100] * 4, abs=35)
