"""copy_ms.single: the device's copies (the answers to the host, the
masks to the device) per traced call, from the profiler's trace, ms
(single entry)."""

from portbench import layers


def read(run):
    return layers.copy_ms(run, "single")
