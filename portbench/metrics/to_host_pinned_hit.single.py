"""to_host_pinned_hit.single: the share of the answers' page-locked host
buffers that torch's caching host allocator served from its cache, not
from a new block (counters ``host.pinned_blocks_created`` over
``depth.to_host_pinned``), % (single entry)."""

from portbench import pinned


def read(run):
    return pinned.hit_share(run, "single")
