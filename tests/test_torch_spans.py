"""The phase spans of the port (`utils/profiling.py:span`) on the CPU.

- With no profiler recording, `span` is one shared no-op context: it
  records nothing and makes no CUDA event, and 100k entries and exits
  take well under half a second.
- Under `torch.profiler` each span is a `vds/<name>` user annotation of
  the exported Chrome trace, inside its parent's range, on the time base
  of the operations it encloses.
- `recorded_spans` hands over each session's spans once: a second
  session's reading holds only its own, also where the first was never
  read; spans opened on many threads at once are each read once, with
  their own thread's parent.
- `train_step` with `grad_accum` 2 records one `vds/step` holding 2
  forward, 2 backward and 1 update span; `inloop_step` at depth 2 records
  1 forward, depth + 2 backward and depth + 1 update spans.
"""

import json
import os
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from video_diffusion_speedrun_tpu_torch.core.config import (
    DiTConfig,
    OptimizerConfig,
    TrainConfig,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.train.inloop import inloop_step
from video_diffusion_speedrun_tpu_torch.train.optim import MupAdamW
from video_diffusion_speedrun_tpu_torch.train.step import train_step
from video_diffusion_speedrun_tpu_torch.utils.profiling import (
    recorded_spans,
    span,
)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def no_earlier_spans():
    recorded_spans()
    yield
    recorded_spans()


def traced(fn, tmp_path):
    """Run fn under the CPU profiler: (fn's result, the host ranges
    (start, end, name) of the exported Chrome trace, in µs)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("ph") == "X"
                 and e.get("cat") in ("cpu_op", "user_annotation")]


def vds(host):
    return [h for h in host if h[2].startswith("vds/")]


def test_off_is_one_shared_noop(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made with the profiler off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    first = span("step", CPU)
    assert span("step/forward", torch.device("cuda")) is first
    t0 = time.perf_counter()
    for _ in range(100_000):
        with span("step", CPU):
            pass
    assert time.perf_counter() - t0 < 0.5
    assert recorded_spans() == []


def test_spans_are_annotations_inside_their_parents(tmp_path):
    def work():
        with span("step", CPU):
            with span("step/forward", CPU):
                y = torch.ones(64, 64) @ torch.ones(64, 64)
            with span("step/backward", CPU):
                y.sum()

    _, host = traced(work, tmp_path)
    got = {name: (a, b) for a, b, name in vds(host)}
    assert sorted(got) == ["vds/step", "vds/step/backward",
                           "vds/step/forward"]
    step = got["vds/step"]
    for child in ("vds/step/forward", "vds/step/backward"):
        assert step[0] <= got[child][0] <= got[child][1] <= step[1]
    # the operations the forward enclosed, on the same time base
    (mm,) = [(a, b) for a, b, name in host if name == "aten::mm"]
    fwd = got["vds/step/forward"]
    assert fwd[0] <= mm[0] <= mm[1] <= fwd[1]
    spans = recorded_spans()
    assert [(s.name, s.parent) for s in spans] == [
        ("vds/step", None), ("vds/step/forward", "vds/step"),
        ("vds/step/backward", "vds/step")]
    assert all(s.ms > 0 for s in spans)
    assert spans[0].ms >= spans[1].ms + spans[2].ms


def test_a_later_session_reads_only_its_own_spans(tmp_path):
    def session(name, n):
        def work():
            for _ in range(n):
                with span(name, CPU):
                    torch.ones(8).sum()
        traced(work, tmp_path)
        return [s.name for s in recorded_spans()]

    assert session("step", 2) == ["vds/step"] * 2
    with span("step", CPU):  # off between sessions: nothing kept
        pass
    assert session("optim/update", 3) == ["vds/optim/update"] * 3
    assert recorded_spans() == []


def test_an_unread_session_is_gone_from_the_next(tmp_path):
    """A session left unread, steps with no profiler, a second session:
    its reading holds its own spans alone, and the record the first left
    is dropped when the second's first span opens."""
    from video_diffusion_speedrun_tpu_torch.utils import profiling

    def work(name, n):
        def go():
            for _ in range(n):
                with span(name, CPU):
                    torch.ones(8).sum()
        return go

    traced(work("step", 4), tmp_path)  # never read
    work("step", 2)()  # no profiler: nothing recorded
    assert [s.name for s in profiling._recorded] == ["vds/step"] * 4
    traced(work("optim/update", 3), tmp_path)
    assert len(profiling._recorded) == 3
    assert [s.name for s in recorded_spans()] == ["vds/optim/update"] * 3


def test_spans_of_many_threads_are_each_read_once():
    """Threads open nested spans while the main thread keeps taking them:
    every span is read once, its parent from its own thread."""
    n = min(32, 2 * (os.cpu_count() or 4))
    each = 200

    def opener():
        for _ in range(each):
            with span("step", CPU):
                with span("step/forward", CPU):
                    pass

    got = []
    prior = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=opener) for _ in range(n)]
            for t in threads:
                t.start()
            while any(t.is_alive() for t in threads):
                got += recorded_spans()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        got += recorded_spans()
    finally:
        sys.setswitchinterval(prior)
    assert len(got) == 2 * n * each
    assert all(s.parent == ("vds/step" if s.name == "vds/step/forward"
                            else None) for s in got)


TINY = DiTConfig(in_channels=4, patch_size=2, time_patch_size=2,
                 hidden_size=64, depth=2, num_heads=2,
                 cross_attn_input_size=32, residual_v=True,
                 attention_impl="plain", fused_adaln="off",
                 compute_dtype=torch.float32)


def setup(in_backward: bool, grad_accum: int):
    torch.manual_seed(0)
    model = DiT(TINY, device="cpu")
    cfg = TrainConfig(model=TINY, batch_size=4, caption_dropout=0.0,
                      max_steps=10, grad_accum=grad_accum,
                      optimizer=OptimizerConfig(in_backward=in_backward))
    opt = MupAdamW(model.named_parameters(), 0.01, 10, cfg.optimizer)
    batch = {"latent": torch.randn(4, 4, 4, 8, 8),
             "context": torch.randn(4, 6, 32)}
    return model, opt, cfg, batch


@pytest.mark.parametrize("step,in_backward,accum,want", [
    (train_step, False, 2, {"vds/step/forward": 2, "vds/step/backward": 2,
                            "vds/optim/update": 1}),
    (inloop_step, True, 1, {"vds/step/forward": 1,
                            "vds/step/backward": TINY.depth + 2,
                            "vds/optim/update": TINY.depth + 1})])
def test_train_steps_record_their_phases(tmp_path, step, in_backward, accum,
                                         want):
    model, opt, cfg, batch = setup(in_backward, accum)
    gen = torch.Generator().manual_seed(1)
    step(model, opt, batch, gen, cfg)  # untraced: records nothing
    assert recorded_spans() == []
    _, host = traced(lambda: step(model, opt, batch, gen, cfg), tmp_path)
    spans = recorded_spans()
    assert spans[0].name == "vds/step" and spans[0].parent is None
    counts = {}
    for s in spans[1:]:
        assert s.parent == "vds/step", s
        counts[s.name] = counts.get(s.name, 0) + 1
    assert counts == want
    assert sorted(h[2] for h in vds(host)) == sorted(s.name for s in spans)
    (a, b, _), = [h for h in vds(host) if h[2] == "vds/step"]
    assert all(a <= h[0] <= h[1] <= b for h in vds(host))
