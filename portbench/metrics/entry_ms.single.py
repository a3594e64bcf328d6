"""entry_ms.single: the mean root span ``pollen.depth.single`` of the
profiled calls less its ``device``, ``to_host`` and ``compose``
children (the mask's upload, the router, the call's own Python), the
program's clock, ms (single entry)."""

from portbench import spans


def read(run):
    return spans.entry_ms(run, "single")
