"""% of the device's idle time inside `vds/step` in gaps that began in the
optimizer's update (`vds/optim/update`)."""

from benchmark import phases


def read(r):
    return phases.idle_share(r, "vds/optim/update")
