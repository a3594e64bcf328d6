"""How often the single routed query's device part replays a captured
CUDA graph, as ``route_replay_hit.single`` reads it: the counters
``depth.route_parts`` (device parts run through the program's cache of
captured graphs) and ``depth.route_replays`` (those that replayed a
graph captured by an earlier call), process-wide (``spans.counters()``).

Read in a traced run on the card of the single entry's cells, as the
span metrics are; elsewhere, and over a program without those counters,
None.
"""

from __future__ import annotations

from portbench import spans


def hit_share(run):
    """100 x replays / parts, %: a key's first call (eager), its capture
    and every call after a failed capture count as misses."""
    if run.entry != "single" or not (run.traced and run.device.type == "cuda"):
        return None
    c = spans.counters()
    parts = c.get("depth.route_parts")
    if not parts:
        return None
    return 100.0 * c.get("depth.route_replays", 0) / parts
