"""Device ms a traced Euler step of HunyuanVideo's double-stream blocks
(`vds/mm/double` spans)."""

from benchmark import phases_hyvideo


def read(r):
    return phases_hyvideo.device_ms(r, "vds/mm/double")
