"""% of the LayerNorm-modulation and GELU-tanh kernels' least time (their
bytes, `counts_hyvideo`) in their device time, over the traced steps."""

from benchmark import counts_hyvideo

NAMES = ("hyv_ln_modulate", "hyv_gelu_tanh")


def read(r):
    s, n = r.shapes, r.launches
    if r.trace is None or not n.get("ln_modulate") or not n.get("gelu_tanh") \
            or not r.traced_steps:
        return None
    secs = sum(b - a for name, a, b, _, _ in r.trace.kernels
               if any(k in name for k in NAMES))
    c, ni, nt = r.config, s["n_img"], s["n_txt"]
    bound = r.traced_steps * (counts_hyvideo.ln_modulate_step_bound(c, ni, nt)
                              + counts_hyvideo.gelu_tanh_step_bound(c, ni,
                                                                    nt))
    return 100.0 * bound / secs if secs > 0 else None
