"""route_ms.batch: the mean host time of the route's device part (the
callable the router returns), ending in a synchronise, ms (batch entry)."""

from portbench import layers


def read(run):
    return layers.route_ms(run, "batch")
