"""The program's own spans and counters (``pollen_tpu_torch.profiling``:
``spans()``, ``counters()``), as the per-layer metrics read them.

Spans record only while a ``torch.profiler`` session is active, so in a
run they are those of the traced calls under the profiler (the
harness's last ``trace_calls`` calls); counters are always on and count
the whole process. They are read in a traced run on the card: on the
CPU a copy to the host and the enqueue of device work are no such
thing, so a CPU run reads nothing here, as it reads no device share. A
program without them (no ``spans`` or ``counters`` in its
``profiling``) gives nothing to read: every function here then returns
None, as it does for the other entry's cells and for a run without
``--trace 1``.
"""

from __future__ import annotations

from statistics import fmean

ROOTS = {"single": "pollen.depth.single", "batch": "pollen.depth.batch"}
DEVICE = "pollen.depth.device"
TO_HOST = "pollen.depth.to_host"
COMPOSE = "pollen.depth.compose"
# A root's direct children that are not the entry's own host work.
OUTSIDE_ENTRY = (DEVICE, TO_HOST, COMPOSE)


def _profiling():
    try:
        from pollen_tpu_torch import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "spans") and hasattr(profiling, "counters")):
        return None
    return profiling


def _on_card(run) -> bool:
    return run.traced and run.device.type == "cuda"


def counters() -> dict:
    prof = _profiling()
    return prof.counters() if prof is not None else {}


def calls(run, entry: str) -> list:
    """Per traced call of ``entry`` (its root spans, the newest
    ``trace_calls``): ``{"root": s, "children": {name: s}, "all": {name:
    s}}``, the root's length, its direct children's and all its
    descendants' summed by name, in seconds; [] where none recorded."""
    prof = _profiling()
    if prof is None or run.entry != entry or not _on_card(run):
        return []
    recorded = prof.spans()
    roots = [s for s in recorded if s.parent is None and s.name == ROOTS[entry]]
    roots = roots[-run.traffic["trace_calls"]:]
    by_call = {r.call: {"root": (r.end_ns - r.start_ns) * 1e-9, "id": r.id,
                        "children": {}, "all": {}} for r in roots}
    for s in recorded:
        c = by_call.get(s.call)
        if c is None or s.id == c["id"]:
            continue
        dur = (s.end_ns - s.start_ns) * 1e-9
        c["all"][s.name] = c["all"].get(s.name, 0.0) + dur
        if s.parent == c["id"]:
            c["children"][s.name] = c["children"].get(s.name, 0.0) + dur
    return list(by_call.values())


def entry_ms(run, entry: str):
    """Mean root span less its device, copy and compose children, ms:
    the mask's upload, the router and the call's own Python."""
    got = calls(run, entry)
    if not got:
        return None
    return 1e3 * fmean(
        c["root"] - sum(c["children"].get(n, 0.0) for n in OUTSIDE_ENTRY)
        for c in got)


def _mean_all(run, entry: str, name: str):
    got = calls(run, entry)
    if not got:
        return None
    return 1e3 * fmean(c["all"].get(name, 0.0) for c in got)


def launch_ms(run, entry: str):
    """Mean ``pollen.depth.device`` a call, ms: the host's enqueue of
    the route's kernels and torch ops."""
    return _mean_all(run, entry, DEVICE)


def to_host_ms(run, entry: str):
    """Mean summed ``pollen.depth.to_host`` a call, ms (each copy holds
    the wait for the device work before it)."""
    return _mean_all(run, entry, TO_HOST)


def to_host_gbps(run, entry: str):
    """Bytes copied to the host a call (``depth.to_host_bytes`` over
    ``depth.calls``) over ``to_host_ms``, GB/s."""
    ms = to_host_ms(run, entry)
    c = counters()
    if not ms or not c.get("depth.calls") or "depth.to_host_bytes" not in c:
        return None
    return c["depth.to_host_bytes"] / c["depth.calls"] / (ms * 1e-3) / 1e9


def ingest_stage_s(run, stage: str):
    """``ingest.<stage>.s`` over ``ingest.builds``: a build's seconds in
    the stage (traced runs on the card only)."""
    c = counters()
    builds = c.get("ingest.builds")
    key = f"ingest.{stage}.s"
    if not _on_card(run) or not builds or key not in c:
        return None
    return c[key] / builds
