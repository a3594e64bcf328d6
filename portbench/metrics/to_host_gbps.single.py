"""to_host_gbps.single: the bytes a call copies to the host (counters
``depth.to_host_bytes`` over ``depth.calls``) over to_host_ms.single,
GB/s (single entry)."""

from portbench import spans


def read(run):
    return spans.to_host_gbps(run, "single")
