"""Tracing and timing utilities.

The port of the JAX package's pollen_tpu/profiling.py: a wall-time
logger for host blocks, a device trace (``torch.profiler`` here, where
the reference takes a ``jax.profiler`` trace) and a best-of wall timer
synchronized on the result's device. For a kernel's device time per
call, replay a captured CUDA graph of back-to-back calls instead
(:mod:`pollen_tpu_torch.probes.timing`: ``replay_us``, ``time_call``).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import time
from typing import Iterator

log = logging.getLogger("pollen_tpu_torch")

_traces = itertools.count()


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
    Perfetto or chrome://tracing) into ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if on_card:
            torch.cuda.synchronize()
    name = f"pollen_tpu_torch.{os.getpid()}.{next(_traces)}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def _first_tensor(out):
    import torch

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
    import torch

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
