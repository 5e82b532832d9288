"""The device trace of a traced segment, reduced to what the per-layer
metrics read.

`Profiled` runs a segment under `torch.profiler` (host and device
activity), writes the Chrome trace to a temporary file, reads it back and
deletes it.
From it come: the device operations (kernels, copies, fills) of card 0
with their names and intervals; the busy time (the union of those
intervals); the host spans of the benchmark (`record_function` names
starting with "bench/") and the device time of the kernels each span
launched; and the idle gaps of the device, each labelled by the
benchmark span and the host operation open when it began.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Tuple

from benchmark.counts import kind_of

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
SPAN_PREFIX = "bench/"


def merged(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """What one traced segment recorded. Times in seconds."""

    def __init__(self, events: List[Dict], window_s: float, card: int = 0):
        self.window_s = window_s
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS
               and int(e.get("args", {}).get("device", 0)) == card]
        self.ops = [(e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                     e.get("args", {}).get("correlation"), e["cat"])
                    for e in dev]
        self.kernels = [o for o in self.ops if o[4] == "kernel"]
        self.busy_s = sum(b - a for a, b in merged(
            [(a, b) for _, a, b, _, _ in self.ops]))
        launches = {e["args"]["correlation"]: (e["ts"], e["tid"])
                    for e in events if e.get("cat") in LAUNCH_CATS
                    and "correlation" in e.get("args", {})}
        host = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in HOST_CATS]
        spans = [e for e in host if e["name"].startswith(SPAN_PREFIX)]
        # device seconds of the kernels launched inside each span name
        self.span_device_s: Dict[str, float] = {}
        by_tid: Dict[int, List[Dict]] = {}
        for s in spans:
            by_tid.setdefault(s["tid"], []).append(s)
        for name, a, b, corr, _ in self.ops:
            launch = launches.get(corr)
            if launch is None:
                continue
            ts, tid = launch
            for s in by_tid.get(tid, ()):
                if s["ts"] <= ts <= s["ts"] + s["dur"]:
                    self.span_device_s[s["name"]] = \
                        self.span_device_s.get(s["name"], 0.0) + (b - a)
        self._host = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                             e["name"]) for e in host)
        self._host_starts = [h[0] for h in self._host]
        self._spans = sorted((s["ts"] * 1e-6, (s["ts"] + s["dur"]) * 1e-6,
                              s["name"]) for s in spans)

    def device_s_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b, _, _ in self.kernels:
            k = kind_of(name)
            out[k] = out.get(k, 0.0) + (b - a)
        return out

    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations with the most time, summed by name."""
        by: Dict[str, float] = {}
        for name, a, b, _, _ in self.ops:
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], secs] for name, secs in top]

    def _label(self, t: float) -> str:
        """The outermost benchmark span and the innermost host event open
        at time t (the latest-starting one that covers t)."""
        span = next((name for a, b, name in self._spans if a <= t <= b),
                    None)
        i = bisect.bisect_right(self._host_starts, t)
        recent = self._host[max(0, i - 400):i]
        inner = next((name for a, b, name in reversed(recent) if b >= t),
                     None)
        if inner is None:
            return span or "no host event"
        return inner if span in (None, inner) else f"{span} > {inner}"

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle time between its operations, summed by what
        the host was doing when each gap began."""
        busy = merged([(a, b) for _, a, b, _, _ in self.ops])
        by: Dict[str, float] = {}
        for (_, end), (start, _) in zip(busy, busy[1:]):
            label = self._label(end)
            by[label] = by.get(label, 0.0) + (start - end)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[label[:160], secs] for label, secs in top]


class Profiled:
    """A profiler of host and device activity over `active` steps after
    one warm-up step: call `step()` after each step. The trace is written
    to a temporary file when the last active step ends; `read` turns it
    into a Trace and deletes the file."""

    def __init__(self, active: int):
        from torch.profiler import ProfilerActivity, profile, schedule

        fd, self.path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=active, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(self.path))

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()

    def step(self) -> None:
        self.prof.step()

    def read(self, window_s: float, card: int = 0) -> Trace:
        try:
            with open(self.path) as f:
                text = f.read()
            events = json.loads(text).get("traceEvents", []) if text else []
        finally:
            os.unlink(self.path)
        return Trace(events, window_s, card)
