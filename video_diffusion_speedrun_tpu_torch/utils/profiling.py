"""Phase spans and MFU (port of `utils/profiling.py`).

`span(name, device)` marks a phase of the program (the train steps'
forward, backward and update) for whoever profiles it: while a
`torch.profiler` session records, the phase is a `vds/<name>` range of
the trace and a pair of CUDA events on `device`'s current stream (the
host's clock on a CPU device); otherwise it is one shared no-op context
that costs a bool read. `recorded_spans()` hands over what the latest
profiling session recorded, each span with its device ms, and forgets it;
the first span recorded after one was asked for with no profiler
recording starts a new session and drops what is left of the older one,
so the record never holds more than one session. `train_mfu` holds a step's
time against the FLOP model (`utils/flops.py`) and the card's bf16 peak.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig
from video_diffusion_speedrun_tpu_torch.utils.flops import (
    dit_train_flops,
    mfu,
)

PREFIX = "vds/"

_OFF = contextlib.nullcontext()


class _Open(threading.local):
    """The spans open on this thread, innermost last."""

    def __init__(self):
        self.stack: List["_Span"] = []


# spans recorded under a profiler, in the order they opened, until
# `recorded_spans` takes them or a new session drops them (under the lock:
# any thread may open one)
_recorded: List["_Span"] = []
_lock = threading.Lock()
_open = _Open()
# set when a span is asked for with no profiler recording: the next span
# recorded opens a new session
_was_off = False


class RecordedSpan(NamedTuple):
    """A span as `recorded_spans` gives it: its trace name, the name of
    the innermost span open around it on its thread (None at the top) and
    the device ms between its entry and exit."""

    name: str
    parent: Optional[str]
    ms: float


class _Span:
    __slots__ = ("name", "parent", "device", "start", "end", "_range")

    def __init__(self, name: str, device: torch.device):
        self.name = PREFIX + name
        self.device = device

    def _mark(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter_ns()

    def __enter__(self):
        global _was_off
        stack = _open.stack
        self.parent = stack[-1].name if stack else None
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start, self.end = self._mark(), None
        stack.append(self)
        with _lock:
            if _was_off:
                _was_off = False
                _recorded.clear()
            _recorded.append(self)
        return None

    def __exit__(self, *exc):
        self.end = self._mark()
        _open.stack.pop()
        self._range.__exit__(*exc)
        return False

    def ms(self) -> float:
        if self.device.type == "cuda":
            return self.start.elapsed_time(self.end)
        return (self.end - self.start) * 1e-6


def span(name: str, device: torch.device):
    """A context that marks phase `name` of work queued on `device`: under
    an active profiler a `vds/<name>` range timed on the device, else one
    shared no-op context (no allocation, no CUDA call, no span kept: only
    a flag that ends the profiling session, if one was recorded)."""
    global _was_off
    if not _profiler._is_profiler_enabled:
        _was_off = True
        return _OFF
    return _Span(name, device)


def recorded_spans() -> List[RecordedSpan]:
    """The closed spans of the latest profiling session not yet taken, in
    the order they opened, each with its device ms (after a sync of the
    devices they timed); the record is emptied, so a later reading never
    holds them. Spans still open stay for the next call. Two sessions
    with no span asked for between them read as one."""
    with _lock:
        done = [s for s in _recorded if s.end is not None]
        _recorded[:] = [s for s in _recorded if s.end is None]
    for dev in {s.device for s in done if s.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return [RecordedSpan(s.name, s.parent, s.ms()) for s in done]


def train_mfu(cfg: DiTConfig, batch: int, t: int, h: int, w: int,
              step_seconds: float, device_name: Optional[str] = None,
              context_len: int = 512) -> float:
    """MFU of a train step of `batch` latents [C, t, h, w] done in
    `step_seconds` on the process group's cards (named `device_name`, by
    default card 0's)."""
    name = device_name or torch.cuda.get_device_name(0)
    return mfu(dit_train_flops(cfg, batch, t, h, w, context_len),
               step_seconds, name)
