"""% of the card's dense bf16 peak that the window's useful FLOPs reach:
each request's steps and its once-a-request work at its own text length
(`counts_hyvideo`), summed by the mode over the window's requests."""

from benchmark import counts


def read(r):
    peak = counts.PEAK_FLOPS.get(r.device_name)
    w = r.window
    if peak is None or not w.get("seconds") or not w.get("flops"):
        return None
    return 100.0 * w["flops"] / (w["seconds"] * r.chips * peak)
