"""host_ms.single: the mean public call minus the mean route device part on
the same masks in the traced run, ms (single entry)."""

from portbench import layers


def read(run):
    return layers.host_ms(run, "single")
