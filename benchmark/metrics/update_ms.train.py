"""Device ms a traced step of the optimizer's updates (`vds/optim/update`),
timed inside the program: the twin of `optimizer_ms.train`, which wraps
the same calls from outside."""

from benchmark import phases


def read(r):
    return phases.device_ms(r, "vds/optim/update")
