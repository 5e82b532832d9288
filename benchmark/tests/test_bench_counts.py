"""The frozen yardsticks reproduce the figures they were copied with, the
trace reduction reads a known timeline, and the per-layer readings hold
each launch against its bound."""

from __future__ import annotations

import json

import pytest

from benchmark import counts, readings
from benchmark.harness import HERE
from benchmark.trace import Trace

CAN = json.loads((HERE / "configs" / "dit-canonical-248m.json").read_text())
DEMO = json.loads((HERE / "configs" / "dit-demo-2.76b.json").read_text())


def test_train_flops_of_the_cells():
    assert counts.dit_train_flops(CAN, 64, (16, 5, 32, 32), 512) / 1e12 \
        == pytest.approx(42.88, abs=0.005)
    assert counts.dit_train_flops(DEMO, 16, (16, 8, 32, 32), 512) / 1e12 \
        == pytest.approx(175.87, abs=0.005)


def test_sampling_flops_count_the_context_once():
    lat = (16, 16, 64, 64)
    full = counts.dit_forward_flops(DEMO, 2, lat, 512)
    step = counts.dit_forward_flops(DEMO, 2, lat, 512, with_context_kv=False)
    assert full / 1e12 == pytest.approx(75.26, abs=0.005)
    assert full - step == counts.context_kv_flops(DEMO, 2, 512)
    assert counts.tokens(DEMO, lat) == 8192


@pytest.mark.parametrize("ms,bound", [
    # PERF.md's kernel table: row 6 at B=2, H=16, 8208²;
    # row 16 at [64, 528, 2048]; row 12 at [64, 528, 512]; row 15
    (1.1161, lambda: counts.attention_bound(2, 16, 8208, 8208, 128, False)),
    (0.1240, lambda: counts.gelu_bwd_bound((64, 528, 2048))),
    (0.0310, lambda: counts.adaln_bwd_bound(64, 528, 512)),
    (0.1606, lambda: counts.gelu_fwd_bound((2, 8208, 8192))),
])
def test_kernel_bounds_match_the_table(ms, bound):
    assert 1e3 * bound() == pytest.approx(ms, abs=5e-5)


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"device": 0, "correlation": corr}}


def host(name, ts, dur, cat="cpu_op", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": {}}


def launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "pid": 1, "tid": tid,
            "args": {"correlation": corr}}


def timeline():
    return [host("bench/step", 0, 1000, "user_annotation"),
            host("aten::mm", 10, 20), launch(15, 1),
            host("bench/optimizer", 500, 100, "user_annotation"),
            launch(510, 2), host("aten::copy_", 700, 50),
            kernel("nvjet_gemm", 100, 200, 1),
            kernel("adamw_multi_tensor_kernel", 250, 150, 2),
            kernel("bias_gelu_bwd_kernel", 800, 100, 3)]


def test_trace_reduction():
    tr = Trace(timeline(), window_s=1e-3)
    assert tr.busy_s == pytest.approx(400e-6)  # [100, 400] ∪ [800, 900]
    assert tr.span_device_s["bench/optimizer"] == pytest.approx(150e-6)
    assert tr.device_s_by_kind() == pytest.approx(
        {"gemm": 200e-6, "adamw": 150e-6, "bias_gelu": 100e-6})
    assert tr.top_ops(1) == [["nvjet_gemm", pytest.approx(200e-6)]]
    # the one gap, [400, 800], opened inside the step after the optimizer
    # span had closed
    assert tr.idle_gaps() == [["bench/step", pytest.approx(400e-6)]]


class FakeReading:
    def __init__(self, trace, launches, steps, mode="train"):
        self.trace, self.launches, self.traced_steps = trace, launches, steps
        self.mode = mode
        self.shapes = {"batch": 64, "heads": 4, "head_dim": 128,
                       "width": 512, "mlp": 2048, "tokens": 512,
                       "registers": 16, "context": 512}


def test_roofline_shares_hold_launches_against_their_bounds():
    none = dict.fromkeys(["self_fwd", "cross_fwd", "long_fwd", "self_bwd",
                          "cross_bwd", "long_bwd", "adaln_fwd", "adaln_bwd",
                          "gated_fwd", "gated_bwd", "gelu_fwd", "gelu_bwd",
                          "adamw"], 0)
    bound = counts.attention_bound(64, 4, 528, 528, 128, False)
    tr = Trace([kernel("fwd_kernel<128>", 0, 2e6 * bound, 1)], 1.0)
    r = FakeReading(tr, dict(none, self_fwd=1), 1)
    assert readings.attention_roofline(r) == pytest.approx(50.0)
    # the final norm's launch covers the patch tokens alone
    b_blk = counts.adaln_fwd_bound(64, 528, 512)
    b_fin = counts.adaln_fwd_bound(64, 512, 512)
    tr = Trace([kernel("adaln_rms_modulate_fwd", 0, 1e6 * (b_blk + b_fin),
                       1)], 1.0)
    r = FakeReading(tr, dict(none, adaln_fwd=2), 1)
    assert readings.epilogue_roofline(r) == pytest.approx(100.0)
    # nothing launched: nothing to read, never 0
    assert readings.attention_roofline(FakeReading(tr, none, 1)) is None


def test_idle_share_holds_traced_busy_time_against_the_window():
    tr = Trace([kernel("k", 0, 100e3, 1), kernel("k", 50e3, 100e3, 2)],
               window_s=9.9)  # the traced wall time is not read
    r = FakeReading(tr, {}, 2)
    # 150 ms busy over 2 traced steps: 75 ms a step
    r.window = {"seconds": 0.75, "steps": 10}
    assert readings.device_idle_share(r) == pytest.approx(0.0, abs=1e-9)
    r.window = {"seconds": 1.5, "steps": 10}
    assert readings.device_idle_share(r) == pytest.approx(50.0)
