"""% of the q/k RMSNorm + RoPE kernel's least time (its bytes,
`counts_hyvideo`) in its device time, over the traced steps."""

from benchmark import counts_hyvideo


def read(r):
    s = r.shapes
    if r.trace is None or not r.launches.get("qknorm_rope") \
            or not r.traced_steps:
        return None
    secs = sum(b - a for name, a, b, _, _ in r.trace.kernels
               if "qk_norm_rope_kernel" in name)
    bound = r.traced_steps * counts_hyvideo.qknorm_rope_step_bound(
        r.config, s["n_img"], s["n_txt"])
    return 100.0 * bound / secs if secs > 0 else None
