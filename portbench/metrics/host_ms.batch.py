"""host_ms.batch: the mean public call minus the mean route device part on
the same masks in the traced run, ms (batch entry)."""

from portbench import layers


def read(run):
    return layers.host_ms(run, "batch")
