"""roofline.single: the least time of a call at 3.35 TB/s (portbench.roofline)
over the kernels' time per traced call (copies left out), % (single entry)."""

from portbench import layers


def read(run):
    return layers.roofline_pct(run, "single")
