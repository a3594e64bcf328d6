"""launch_ms.single: the mean span ``pollen.depth.device`` a profiled
call, the host's enqueue of the route's device part with no wait for
it, the program's clock, ms (single entry)."""

from portbench import spans


def read(run):
    return spans.launch_ms(run, "single")
