"""% of the device's idle time inside `vds/step` in gaps that began in the
forward (`vds/step/forward`)."""

from benchmark import phases


def read(r):
    return phases.idle_share(r, "vds/step/forward")
