"""Device ms a traced step of the forward phases (`vds/step/forward`)."""

from benchmark import phases


def read(r):
    return phases.device_ms(r, "vds/step/forward")
