"""The readers of the train steps' phases (`phases.py`, `metrics/`): the
idle shares and the phases' device ms on a made-up trace with known
gaps, the program's spans in the benchmark's `Trace`, and the seven
metrics read end to end from the tiny train cells.

A CPU run has no device operation, so the tiny cells' traced runs give
no device metric (`test_bench_layout.py`). Here the host's operations
stand in for the device's: `trace.DEVICE_CATS` takes `cpu_op` too, so the
phases' readers have operations, gaps and busy time to read.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, phases, trace

SEVEN = ("forward_ms.train", "backward_ms.train", "update_ms.train",
         "update_ms.speedrun", "forward_idle_share.speedrun",
         "backward_idle_share.speedrun", "update_idle_share.speedrun")


def x(cat, name, start_us, end_us, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": start_us,
            "dur": end_us - start_us, "tid": tid, "args": {"device": 0}}


def made_up_trace() -> trace.Trace:
    """One step, its phases on the main thread (tid 1), the backward's
    host operations on the autograd thread (tid 2), and a forward range
    outside any step (1–7). Busy intervals and the gaps between them
    (µs):
      before the step      [0, 5]   gap 5–10 (outside vds/step)
      forward              [10, 20] gap 20–30 (10, forward)
      step's own time      [30, 40] gap 40–44 (4, between the phases)
      backward             [44, 50] gap 50–70 (20, backward; 500 host
                           events open and close between the backward's
                           start and this gap)
      update               [70, 80] gap 80–82 (2, update)
      after the update     [82, 90] gap 90–96 (6, the step again)
      after the step       [96, 99]"""
    ev = [x("user_annotation", "vds/step/forward", 1, 7),  # no step's
          x("user_annotation", "vds/step", 8, 97),
          x("user_annotation", "vds/step/forward", 9, 29),
          x("user_annotation", "vds/step/backward", 41, 69),
          x("user_annotation", "vds/optim/update", 69.5, 81)]
    ev += [x("cpu_op", f"aten::op{i}", 42 + 0.01 * i,
             42 + 0.01 * i + 0.005, tid=2) for i in range(500)]
    busy = [(0, 5), (10, 20), (30, 40), (44, 50), (70, 80), (82, 90),
            (96, 99)]
    ev += [x("kernel", f"k{i}", a, b, tid=7)
           for i, (a, b) in enumerate(busy)]
    return trace.Trace(ev, 1e-4)


def test_gaps_go_to_the_innermost_open_phase():
    tr = made_up_trace()
    assert len([h for h in tr._host if 42e-6 < h[0] < 50e-6]) > 400
    got = phases.idle_in_step(tr)
    want = {"vds/step/forward": 10e-6, "vds/step": 10e-6,
            "vds/step/backward": 20e-6, "vds/optim/update": 2e-6}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    r = SimpleNamespace(trace=tr, traced_steps=1)
    shares = {name: harness.reader_of(name)(r) for name in SEVEN
              if "idle" in name}
    assert shares == pytest.approx({
        "forward_idle_share.speedrun": 100 * 10 / 42,
        "backward_idle_share.speedrun": 100 * 20 / 42,
        "update_idle_share.speedrun": 100 * 2 / 42})


def test_device_ms_is_the_extent_less_the_idle_inside():
    """Each phase's event pair on a device idle at its edges spans its
    host range: forward 9–29 µs holds 10 busy and 1 + 9 idle, backward
    41–69 holds 6 busy and 3 + 19 idle, update 69.5–81 holds 10 busy and
    0.5 + 1 idle. A span outside `vds/step` is no phase."""
    tr = made_up_trace()
    assert phases.idle_within(tr, "vds/step/forward") == \
        pytest.approx(10e-6)
    spans = [SimpleNamespace(name=n, parent=parent, ms=us * 1e-3)
             for n, parent, us in (
                 ("vds/step/forward", None, 6), ("vds/step", None, 89),
                 ("vds/step/forward", "vds/step", 20),
                 ("vds/step/backward", "vds/step", 28),
                 ("vds/optim/update", "vds/step", 11.5))]
    r = SimpleNamespace(trace=tr, traced_steps=1, _phase_spans=spans)
    got = {name: harness.reader_of(name)(r) for name in SEVEN
           if name.endswith("ms.train")}
    assert got == pytest.approx({"forward_ms.train": 10e-3,
                                 "backward_ms.train": 6e-3,
                                 "update_ms.train": 10e-3})
    r.traced_steps = 2
    assert harness.reader_of("update_ms.speedrun")(r) == \
        pytest.approx(5e-3)


def test_program_spans_reach_the_trace(tmp_path):
    """Under `torch.profiler` on the CPU each span is a `vds/` range of
    the benchmark's `Trace`, inside its parent's, on the time base of the
    operations it encloses."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from benchmark import program

    prof_mod = program.module("utils.profiling")
    span, cpu = prof_mod.span, torch.device("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("step", cpu):
            with span("step/forward", cpu):
                torch.ones(64, 64) @ torch.ones(64, 64)
    prof_mod.recorded_spans()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    tr = trace.Trace(json.loads(path.read_text())["traceEvents"], 0.0)
    got = {n: (a, b) for a, b, n in phases._annotations(tr)}
    assert sorted(got) == ["vds/step", "vds/step/forward"]
    step, fwd = got["vds/step"], got["vds/step/forward"]
    assert step[0] <= fwd[0] <= fwd[1] <= step[1]
    (mm,) = [(a, b) for a, b, n in tr._host if n == "aten::mm"]
    assert fwd[0] <= mm[0] <= mm[1] <= fwd[1]


def test_nothing_to_read_gives_none():
    empty = trace.Trace([], 0.0)
    no_spans = trace.Trace([x("kernel", "k", 0, 1), x("kernel", "k", 2, 3)],
                           0.0)
    for tr in (None, empty, no_spans):
        r = SimpleNamespace(trace=tr, traced_steps=1)
        for name in SEVEN:
            assert harness.reader_of(name)(r) is None, (name, tr)


@pytest.fixture
def host_as_device(monkeypatch):
    monkeypatch.setattr(trace, "DEVICE_CATS",
                        trace.DEVICE_CATS + ("cpu_op",))


def with_seven(tiny, cells):
    for m in tiny.spec["per_layer"]:
        if m["name"] in SEVEN:
            m["workloads"] += [c for c in cells if c not in m["workloads"]]


SPANS_A_STEP = """
from benchmark import phases


def read(r):
    got = phases.spans(r)
    return None if got is None else len(got) / r.traced_steps
"""


def test_tiny_train_cells_read_all_seven(tiny, host_as_device):
    """Both train steps, traced end to end: every new metric is a number,
    the shares of the idle time are shares, and the two update metrics
    read the same spans."""
    with_seven(tiny, ("tiny-train", "tiny-inbwd"))
    for cell in ("tiny-train", "tiny-inbwd"):
        out = tiny.run(cell, trace=True)
        assert out["correct"], out["checks"]
        got = {k: out["metrics"][k]["value"] for k in SEVEN}
        assert all(isinstance(v, float) and v > 0 for k, v in got.items()
                   if "share" not in k), got
        shares = [got[k] for k in SEVEN if "share" in k]
        assert all(0 <= v <= 100 for v in shares) and sum(shares) <= 100
        assert got["update_ms.train"] == got["update_ms.speedrun"]


def test_two_traced_cells_do_not_mix_their_spans(tiny, host_as_device):
    """Spans left unread by an earlier profiling session, then two traced
    cells: each reading holds its own step's spans alone (depth 2: 4 a
    standard step; 1 + 1 + 4 + 3 an in-backward step)."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import program

    span = program.module("utils.profiling").span
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with span("step", torch.device("cpu")):
                pass
    (tiny.dir / "metrics").mkdir()
    (tiny.dir / "metrics" / "spans_a_step.train.py").write_text(SPANS_A_STEP)
    tiny.spec["per_layer"].append({
        "name": "spans_a_step.train", "unit": "spans", "better": "lower",
        "source": "program_span", "layer": "step",
        "moves": "train_tokens_per_s",
        "workloads": ["tiny-train", "tiny-inbwd"]})
    with_seven(tiny, ("tiny-train", "tiny-inbwd"))
    a = tiny.run("tiny-train", trace=True)["metrics"]
    b = tiny.run("tiny-inbwd", trace=True)["metrics"]
    assert a["spans_a_step.train"]["value"] == 4
    assert b["spans_a_step.train"]["value"] == 9
