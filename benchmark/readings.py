"""The per-layer quantities, read from a run's `Reading` (harness.py): the
traced segment's device trace and launch counts, and the untraced window.
A per-layer metric without a reader of its own under `metrics/` is read
by the function here named by its name up to the first dot
(`harness.reader_of`). Each returns None where the run gives it nothing to
read, never 0 for a share."""

from __future__ import annotations

from typing import Optional

from benchmark import counts


def device_idle_share(r) -> Optional[float]:
    """% of a step's wall time in which no operation ran on card 0: the
    traced segment's device busy time a step (the union of its operations'
    intervals) against the untraced window's wall time a step. The
    profiler slows the host, so the traced segment's own wall time would
    overstate the idle time of a host-bound step."""
    tr, w = r.trace, r.window
    if tr is None or tr.busy_s <= 0 or not r.traced_steps \
            or not w.get("steps"):
        return None
    busy = tr.busy_s / r.traced_steps
    return 100.0 * max(0.0, 1.0 - busy / (w["seconds"] / w["steps"]))


def step_mfu(r) -> Optional[float]:
    """% of the cards' dense bf16 peak that the window's useful FLOPs (the
    frozen FLOP model; the remat recompute not counted) reach."""
    peak = counts.PEAK_FLOPS.get(r.device_name)
    w, s = r.window, r.shapes
    if peak is None or not w.get("seconds"):
        return None
    if r.mode == "train":
        flops = s["step_flops"] * w["steps"]
    else:
        flops = s["request_flops"] * w["requests"]
    return 100.0 * flops / (w["seconds"] * r.chips * peak)


def _per_step(r, value: float) -> Optional[float]:
    return value / r.traced_steps if r.traced_steps else None


def kernels_per_step(r) -> Optional[float]:
    """Device kernels launched per step (train step or Euler step)."""
    if r.trace is None or not r.trace.kernels:
        return None
    return _per_step(r, float(len(r.trace.kernels)))


def optimizer_ms(r) -> Optional[float]:
    """Device ms per step of the kernels launched inside the optimizer's
    `bench/optimizer` spans."""
    if r.trace is None:
        return None
    secs = r.trace.span_device_s.get("bench/optimizer")
    return None if not secs else _per_step(r, 1e3 * secs)


def _roofline(r, kinds, bound_s: float) -> Optional[float]:
    if r.trace is None or bound_s <= 0:
        return None
    by = r.trace.device_s_by_kind()
    secs = sum(by.get(k, 0.0) for k in kinds)
    return 100.0 * bound_s / secs if secs > 0 else None


def attention_roofline(r) -> Optional[float]:
    """% of the attention kernels' least time (each launch's operations
    and bytes at its shape) in their device time."""
    s, n = r.shapes, r.launches
    if not n:
        return None
    b, h, d = s["batch"], s["heads"], s["head_dim"]
    l, lc = s["tokens"] + s["registers"], s["context"]
    bound = ((n["self_fwd"] + n["long_fwd"])
             * counts.attention_bound(b, h, l, l, d, False)
             + (n["self_bwd"] + n["long_bwd"])
             * counts.attention_bound(b, h, l, l, d, True)
             + n["cross_fwd"] * counts.attention_bound(b, h, l, lc, d, False)
             + n["cross_bwd"] * counts.attention_bound(b, h, l, lc, d, True))
    return _roofline(r, ("attention",), bound)


def epilogue_roofline(r) -> Optional[float]:
    """% of the AdaLN, gated-residual and bias+GELU kernels' least time in
    their device time. One AdaLN forward a step (and one backward a train
    step) is the final norm's, over the patch tokens alone."""
    s, n = r.shapes, r.launches
    if not n or not r.traced_steps:
        return None
    b, dm, f = s["batch"], s["width"], s["mlp"]
    lp = s["tokens"]
    l = lp + s["registers"]
    fwd_final = r.traced_steps
    bwd_final = r.traced_steps if n["adaln_bwd"] else 0
    bound = ((n["adaln_fwd"] - fwd_final) * counts.adaln_fwd_bound(b, l, dm)
             + fwd_final * counts.adaln_fwd_bound(b, lp, dm)
             + (n["adaln_bwd"] - bwd_final) * counts.adaln_bwd_bound(b, l, dm)
             + bwd_final * counts.adaln_bwd_bound(b, lp, dm)
             + n["gated_fwd"] * counts.gated_fwd_bound(b, l, dm)
             + n["gated_bwd"] * counts.adaln_bwd_bound(b, l, dm, gated=True)
             + n["gelu_fwd"] * counts.gelu_fwd_bound((b, l, f))
             + n["gelu_bwd"] * counts.gelu_bwd_bound((b, l, f)))
    return _roofline(r, counts.EPILOGUE_KINDS, bound)

