"""Device ms a traced step of the backward phases (`vds/step/backward`):
the remat recompute, or the in-backward walk's per-block recompute, with
the gradients."""

from benchmark import phases


def read(r):
    return phases.device_ms(r, "vds/step/backward")
