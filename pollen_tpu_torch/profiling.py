"""Tracing and timing utilities.

The port of the JAX package's pollen_tpu/profiling.py: a wall-time
logger for host blocks, a device trace (``torch.profiler`` here, where
the reference takes a ``jax.profiler`` trace) and a best-of wall timer
synchronized on the result's device. For a kernel's device time per
call, replay a captured CUDA graph of back-to-back calls instead
(:mod:`pollen_tpu_torch.probes.timing`: ``replay_us``, ``time_call``).

Spans and counters inside the program: ``span(name)`` marks a block of
a public call (the depth queries, ``build_graph``). A span records only
while a ``torch.profiler`` session is active or inside ``recording()``;
otherwise it is one shared null context, one check a span. Under a
profiler each span is also a profiler event of the same name (category
``cpu_op``; ``user_annotation`` where torch lacks the fast form), so it
sits in the Chrome trace beside the card's kernels and copies. Recorded
spans (``spans()``) keep their name, their start and end
(``time.perf_counter_ns``), their parent and the call they belong to (a
root span opens a call; its descendants share its id), the newest
``SPAN_BUFFER`` of them. ``count(name, n)`` adds to a process-wide
counter, always on (``counters()``, which once CUDA is initialised also
reports ``host.pinned_blocks_created``: the page-locked blocks torch's
caching host allocator made). ``reset()`` clears both.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import threading
import time
from typing import Iterator, NamedTuple, Optional

import torch

log = logging.getLogger("pollen_tpu_torch")

_traces = itertools.count()

# Idle time kept inside a card's trace window on each side of the block.
# The profiler keeps only the device events whose timestamps fall inside
# its window, and on an H100 under host load those timestamps can read
# milliseconds off the calls that launched them (probes/trace_skew.py):
# a block traced from its first instruction then lost every kernel event.
_TRACE_MARGIN_S = 0.05

# Spans kept in memory; the oldest are dropped past it.
SPAN_BUFFER = 1 << 16

_profiler_enabled = torch.autograd._profiler_enabled
# The profiler's event for a span: the C++ context manager behind
# ``record_function``'s fast path (~1 us an event on a CPU against ~16 us
# for ``record_function``, whose enter and exit are dispatched ops).
_event = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


class Span(NamedTuple):
    """A recorded span: ``parent`` is the enclosing span's ``id`` (None
    for a root), ``call`` the id of the root it belongs to."""

    id: int
    name: str
    call: int
    parent: Optional[int]
    start_ns: int
    end_ns: int


_spans: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_counters: dict = {}
_ids = itertools.count(1)
# Open spans nest per thread; the buffer, the counters and the
# recording depth are the process's, updated under the lock.
_local = threading.local()
_lock = threading.Lock()
_recording = 0
_NULL = contextlib.nullcontext()
# The host allocator's blocks made before the last reset().
_pinned_base = 0


class _Open:
    """A span being recorded: its place on the thread's stack of open
    spans, and under a profiler its event. Its clock reads enclose the
    event's, so that a child's span holds its own event's cost, not its
    parent's."""

    __slots__ = ("name", "id", "call", "parent", "start", "_event")

    def __init__(self, name: str, profiled: bool):
        self.name = name
        self._event = _event(name) if profiled else None

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.id = next(_ids)
        top = stack[-1] if stack else None
        self.parent = top.id if top else None
        self.call = top.call if top else self.id
        stack.append(self)
        self.start = time.perf_counter_ns()
        if self._event is not None:
            self._event.__enter__()
        return self

    def __exit__(self, *exc):
        if self._event is not None:
            self._event.__exit__(*exc)
        end = time.perf_counter_ns()
        _local.stack.pop()
        span = Span(self.id, self.name, self.call, self.parent, self.start, end)
        with _lock:
            _spans.append(span)
        return False


def span(name: str):
    """A context manager that records the block as span ``name`` while a
    ``torch.profiler`` session is active or inside ``recording()``, and
    else is one shared null context that allocates nothing."""
    profiled = _profiler_enabled()
    if _recording or profiled:
        return _Open(name, profiled)
    return _NULL


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside the block, with no profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def count(name: str, n=1) -> None:
    """Add ``n`` to the process-wide counter ``name``; always on."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def spans() -> list:
    """The recorded spans, oldest first, each closed (a ``Span``)."""
    with _lock:
        return list(_spans)


def _pinned_blocks() -> Optional[int]:
    """The page-locked blocks torch's caching host allocator has made in
    this process (``num_host_alloc``), read only once CUDA is
    initialised; else None."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.host_memory_stats().get("num_host_alloc")


def counters() -> dict:
    """A snapshot of the counters, with ``host.pinned_blocks_created``
    (the host allocator's new blocks since the last reset) once CUDA is
    initialised."""
    with _lock:
        out = dict(_counters)
    made = _pinned_blocks()
    if made is not None:
        out["host.pinned_blocks_created"] = made - _pinned_base
    return out


def reset() -> None:
    """Clear the recorded spans and the counters."""
    global _pinned_base
    with _lock:
        _spans.clear()
        _counters.clear()
        _pinned_base = _pinned_blocks() or 0


@contextlib.contextmanager
def stopwatch(label: str) -> Iterator[None]:
    """Log wall time for a host-side block."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log.info("%s: %.3f s", label, time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (host activity, and the
    card's when one is present) and write a Chrome trace (view in
    Perfetto or chrome://tracing) into ``log_dir``. On the card the
    window opens and closes ``_TRACE_MARGIN_S`` away from the block, with
    the card idle, so that a skew of the device clock keeps its events.
    The block itself, with the wait for its device work on the card, is
    the span ``pollen.trace_block``: a reader cuts the margins there."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if on_card:
            time.sleep(_TRACE_MARGIN_S)
        with span("pollen.trace_block"):
            yield
            if on_card:
                torch.cuda.synchronize()
        if on_card:
            time.sleep(_TRACE_MARGIN_S)
    name = f"pollen_tpu_torch.{os.getpid()}.{next(_traces)}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for item in out:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def _sync(out) -> None:
    """Wait for the card that holds the result's first tensor; nothing
    to wait for on the CPU or for host results."""
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def time_best(fn, *args, reps: int = 3, warmup: int = 1) -> float:
    """Best wall time in seconds of ``fn(*args)``, synchronized on the
    result (the counterpart of the reference's ``time_jitted``)."""
    for _ in range(warmup):
        _sync(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best
