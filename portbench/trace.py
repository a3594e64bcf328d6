"""Reading a ``torch.profiler`` Chrome trace: device busy time, the
device operations that took most of it, and the idle gaps named by
what the host was doing.

The traced calls run inside a ``record_function`` span named
``WINDOW``, and each call inside one named ``CALL``; the window is that
span's length on the host. Busy time counts every device event
(kernels, copies, memsets); ``kernel_s`` and ``copy_s`` count kernels
alone and copies alone. The profiler's window opens and closes a
margin away from it with the card idle (device timestamps can read
milliseconds off their launches, and the profiler drops device events
outside its own window), so every device event in the trace belongs to
the traced calls: all of them count as busy, and the margins do not
count in the window.
"""

from __future__ import annotations

import collections
import json

WINDOW = "portbench.window"
CALL = "portbench.call"
KERNEL_CATS = {"kernel"}
COPY_CATS = {"gpu_memcpy"}
DEVICE_CATS = KERNEL_CATS | COPY_CATS | {"gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
NAME_CHARS = 120


def load(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _spans(events, cats):
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats and "dur" in e:
            ts = float(e["ts"])
            out.append((ts, ts + float(e["dur"]), str(e.get("name", ""))))
    return out


def merge(spans):
    """Sorted, disjoint (start, end) cover of the spans."""
    out = []
    for lo, hi, _ in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _length(merged) -> float:
    """Seconds covered by a merged cover of microsecond spans."""
    return sum(hi - lo for lo, hi in merged) * 1e-6


def _host_name(host, t):
    """The innermost host span (latest start, then earliest end) that
    covers time ``t``."""
    best = None
    for lo, hi, name in host:
        if lo <= t <= hi and (best is None or (lo, -hi) > best[0]):
            best = ((lo, -hi), name)
    if best is None or best[1] == WINDOW:
        return "harness, between calls"
    if best[1] == CALL:
        return "inside the call, outside torch ops (host numpy)"
    return best[1][:NAME_CHARS]


def reading(events) -> dict | None:
    """``busy_s``, ``kernel_s``, ``copy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` (each
    a list of [name, seconds], largest first, at most 10) of a trace; None
    where the trace holds no ``WINDOW`` span."""
    host = _spans(events, HOST_CATS)
    win = [(lo, hi) for lo, hi, name in host if name == WINDOW]
    if not win:
        return None
    w_lo, w_hi = win[0]
    device = _spans(events, DEVICE_CATS)
    busy = merge(device)
    ops = collections.Counter()
    for lo, hi, name in device:
        ops[name[:NAME_CHARS]] += (hi - lo) * 1e-6
    gaps = collections.Counter()
    edges = [w_lo] + [x for b in busy for x in b] + [w_hi]
    for lo, hi in zip(edges[0::2], edges[1::2]):
        lo, hi = max(lo, w_lo), min(hi, w_hi)
        if hi > lo:
            gaps[_host_name(host, (lo + hi) / 2)] += (hi - lo) * 1e-6
    return dict(
        busy_s=_length(busy),
        kernel_s=_length(merge(_spans(events, KERNEL_CATS))),
        copy_s=_length(merge(_spans(events, COPY_CATS))),
        window_s=(w_hi - w_lo) * 1e-6,
        device_ops=[[n, s] for n, s in ops.most_common(10)],
        idle_gaps=[[n, s] for n, s in gaps.most_common(10)],
    )
