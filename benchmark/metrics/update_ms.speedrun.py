"""Device ms a traced step of the optimizer's update (`vds/optim/update`),
timed inside the program: the twin of `optimizer_ms.speedrun`."""

from benchmark import phases


def read(r):
    return phases.device_ms(r, "vds/optim/update")
