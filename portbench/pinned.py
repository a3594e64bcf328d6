"""How often the program's answers reuse a page-locked host block, as
``to_host_pinned_hit.single`` and ``.batch`` read it: the counters
``depth.to_host_pinned`` (page-locked buffers the entries asked for)
and ``host.pinned_blocks_created`` (blocks torch's caching host
allocator made to serve them), process-wide (``spans.counters()``).

Read in a traced run on the card of the entry's own cell, as the span
metrics are; elsewhere, and over a program without those counters,
None.
"""

from __future__ import annotations

from portbench import spans


def hit_share(run, entry: str):
    """100 x (1 - blocks made / buffers asked for), %: the share of the
    answers' page-locked buffers served from the allocator's cache."""
    if run.entry != entry or not (run.traced and run.device.type == "cuda"):
        return None
    c = spans.counters()
    asked = c.get("depth.to_host_pinned")
    if not asked or "host.pinned_blocks_created" not in c:
        return None
    return 100.0 * (1.0 - c["host.pinned_blocks_created"] / asked)
