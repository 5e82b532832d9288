"""Device ms a traced Euler step of HunyuanVideo's single-stream blocks
(`vds/mm/single` spans)."""

from benchmark import phases_hyvideo


def read(r):
    return phases_hyvideo.device_ms(r, "vds/mm/single")
