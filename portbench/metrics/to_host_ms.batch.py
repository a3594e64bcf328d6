"""to_host_ms.batch: the mean summed spans ``pollen.depth.to_host`` a
profiled call, the answers' copies to the host with the wait for the
device work before them, the program's clock, ms (batch entry)."""

from portbench import spans


def read(run):
    return spans.to_host_ms(run, "batch")
