"""The device ms a sampling step of HunyuanVideo's block spans: the
`vds/mm/double` and `vds/mm/single` spans directly inside each Euler
step's `vds/sample/step`, read as `phases.py` reads the train steps'
phases (each span's CUDA event pair, less the device's idle while its host
range is open), over the traced steps. None where the run gives nothing to
read: a trace with no device operation, or a program without the spans.
"""

from __future__ import annotations

from typing import Optional

from benchmark import phases
from benchmark.trace import merged

STEP = "vds/sample/step"


def idle_within(tr, name: str) -> float:
    """Seconds of the device's idle time while a host range `name` that
    lies inside a `vds/sample/step` range is open."""
    ranges = phases._annotations(tr)
    steps = [(a, b) for a, b, n in ranges if n == STEP]
    open_ = merged([(a, b) for a, b, n in ranges if n == name
                    and any(s <= a and b <= e for s, e in steps)])
    gaps, i, total = phases._gaps(tr), 0, 0.0
    for a, b in open_:  # both sorted and disjoint
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            total += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
    return total


def device_ms(r, name: str) -> Optional[float]:
    """Σ device ms of the spans named `name` inside the sampling steps,
    their extents less the idle inside them, over the traced steps."""
    ms = [s.ms for s in phases.spans(r) or () if s.name == name
          and s.parent == STEP]
    if not ms or not r.traced_steps:
        return None
    return (sum(ms) - 1e3 * idle_within(r.trace, name)) / r.traced_steps
