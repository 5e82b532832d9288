"""% of the attention kernels' least time in their device time, over the
traced steps: each block's joint attention at L = video + valid text rows
and the refiner's over the text rows (`counts_hyvideo`), B = 1, H = 24,
D = 128, forward only."""

from benchmark import counts_hyvideo, readings


def read(r):
    s = r.shapes
    if not r.launches.get("long_fwd") or not r.traced_steps:
        return None
    bound = r.traced_steps * counts_hyvideo.attention_step_bound(
        r.config, s["n_img"], s["n_txt"])
    return readings._roofline(r, ("attention",), bound)
