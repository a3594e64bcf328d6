"""The arithmetic of the per-layer metrics, shared by their readers in
``metrics/``. Each function takes the run and the entry its metric
belongs to, and returns None where the run holds nothing to read: the
other entry's cells, a run without ``--trace 1``, or a trace with no
device activity (never 0 for a share)."""

from __future__ import annotations

from statistics import fmean

from . import roofline


def _traced(run, entry: str) -> bool:
    return run.entry == entry and run.traced and bool(run.public_s)


def route_ms(run, entry: str):
    """Mean host time of the route's device part, ending in a
    synchronise, in ms."""
    return 1e3 * fmean(run.route_s) if _traced(run, entry) else None


def host_ms(run, entry: str):
    """Mean public call minus mean route device part, same masks, ms."""
    if not _traced(run, entry):
        return None
    return 1e3 * (fmean(run.public_s) - fmean(run.route_s))


def _busy(run, entry: str):
    if not _traced(run, entry) or not run.trace or run.trace["busy_s"] <= 0:
        return None
    return run.trace


def roofline_pct(run, entry: str):
    """The least time of a traced call (``roofline``, the mean of their
    bytes) over the kernels' time
    per traced call (copies and memsets left out), in %."""
    tr = _busy(run, entry)
    if tr is None or tr["kernel_s"] <= 0:
        return None
    return 100 * roofline.least_s(run.call_bytes) / (tr["kernel_s"] / tr["calls"])


def copy_ms(run, entry: str):
    """The device's copies (to and from the host, and on the device)
    per traced call, in ms."""
    tr = _busy(run, entry)
    if tr is None or tr["copy_s"] <= 0:
        return None
    return 1e3 * tr["copy_s"] / tr["calls"]


def device_idle_pct(run, entry: str):
    """1 - busy / window over the traced window, in %."""
    tr = _busy(run, entry)
    if tr is None:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
