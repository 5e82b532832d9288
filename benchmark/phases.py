"""The phases of the program's train steps, read from its `vds/` spans:
the `vds/step` of each step, and inside it the forward
(`vds/step/forward`), the backward (`vds/step/backward`) and the update
(`vds/optim/update`).

Two readings, each None where the run gives nothing to read: a trace
that saw no device operation, or a program without the spans.
- `device_ms`: the device ms a traced step of the phase spans (those
  directly inside `vds/step`) of one name. The program times each span
  with a pair of CUDA events on its stream (`utils/profiling.
  recorded_spans`): the span's device extent, the idle inside it
  included. The trace does not link a program span to the kernels it
  launched, so that idle is taken off: while the device is idle, all
  work queued before has run, so an event recorded then runs at once and
  the idle inside a span's event pair is the idle while its host range
  is open (`idle_within`).
- `idle_share`: the share of the device's idle time inside `vds/step`
  that falls in gaps put down to one phase. A gap (between two merged
  busy intervals of the trace's device operations) goes to the innermost
  (latest-starting) `vds/` annotation open at its start, on any thread:
  the backward's kernels are launched from the autograd thread while the
  main thread holds `vds/step/backward`. This says what the host was
  doing when the device ran dry, where `idle_within` splits a gap at the
  span's edges.

`Trace` keeps its host ranges in `_host` alone; the readers take the
`vds/` ones from there.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from benchmark import program
from benchmark.trace import merged

PREFIX = "vds/"
STEP = "vds/step"


def _annotations(tr) -> List:
    """The trace's `vds/` host ranges (start, end, name), by start."""
    return [h for h in tr._host if h[2].startswith(PREFIX)]


def spans(r) -> Optional[List]:
    """The program's spans of this reading's traced segment, taken from
    the program once and kept on the reading: of what the program
    recorded (its latest profiling session), the last as many as the
    trace holds `vds/` annotations, which also holds where two sessions
    ran with no span between them."""
    if r.trace is None or not r.trace.ops:
        return None
    if not hasattr(r, "_phase_spans"):
        recorded = getattr(program.module("utils.profiling"),
                           "recorded_spans", None)
        got = [] if recorded is None else recorded()
        n = len(_annotations(r.trace))
        r._phase_spans = got[len(got) - n:] if n else []
    return r._phase_spans


def _gaps(tr) -> List:
    """The device's idle intervals between its merged busy intervals."""
    busy = merged([(a, b) for _, a, b, _, _ in tr.ops])
    return [(t, resume) for (_, t), (resume, _) in zip(busy, busy[1:])]


def idle_within(tr, name: str) -> float:
    """Seconds of the device's idle time while a host range `name` that
    lies inside a `vds/step` range is open."""
    ranges = _annotations(tr)
    steps = [(a, b) for a, b, n in ranges if n == STEP]
    open_ = merged([(a, b) for a, b, n in ranges if n == name
                    and any(s <= a and b <= e for s, e in steps)])
    gaps, i, total = _gaps(tr), 0, 0.0
    for a, b in open_:  # both sorted and disjoint
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            total += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
    return total


def device_ms(r, name: str) -> Optional[float]:
    """Σ device ms of the phase spans named `name`, their extents less
    the idle inside them, over the traced steps."""
    ms = [s.ms for s in spans(r) or () if s.name == name
          and s.parent == STEP]
    if not ms or not r.traced_steps:
        return None
    return (sum(ms) - 1e3 * idle_within(r.trace, name)) / r.traced_steps


def idle_in_step(tr) -> Optional[Dict[str, float]]:
    """The device's idle seconds inside `vds/step`, by the innermost
    `vds/` annotation open when each gap began."""
    if tr is None or not tr.ops:
        return None
    ranges = _annotations(tr)
    if not any(name == STEP for _, _, name in ranges):
        return None
    starts = [a for a, _, _ in ranges]
    out: Dict[str, float] = {}
    for t, resume in _gaps(tr):
        open_ = [h for h in ranges[:bisect.bisect_right(starts, t)]
                 if h[1] >= t]
        if any(name == STEP for _, _, name in open_):
            inner = max(open_, key=lambda h: (h[0], -h[1]))[2]
            out[inner] = out.get(inner, 0.0) + (resume - t)
    return out


def idle_share(r, name: str) -> Optional[float]:
    """% of the device's idle time inside `vds/step` put down to `name`."""
    by = idle_in_step(r.trace)
    total = sum(by.values()) if by else 0.0
    if total <= 0:
        return None
    return 100.0 * by.get(name, 0.0) / total
