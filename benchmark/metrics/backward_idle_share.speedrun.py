"""% of the device's idle time inside `vds/step` in gaps that began in the
backward (`vds/step/backward`, the remat recompute included)."""

from benchmark import phases


def read(r):
    return phases.idle_share(r, "vds/step/backward")
