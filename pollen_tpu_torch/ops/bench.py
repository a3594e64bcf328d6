"""Micro-benchmarks: a copy of pollen_tpu/ops/bench.py (reference
analogue: flatgfa/src/ops/bench.rs — a serial vs parallel ``wc -l``)."""

from __future__ import annotations

import concurrent.futures
import mmap
import os


def _count_range(filename: str, lo: int, hi: int) -> int:
    with open(filename, "rb") as f:
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
            return bytes(m[lo:hi]).count(b"\n")


def line_count(filename: str, parallel: bool = False) -> int:
    """Count newlines in a file; ``parallel`` splits it into per-core
    byte ranges (the rayon work-splitting analogue)."""
    size = os.path.getsize(filename)
    if not parallel or size < 1 << 20:
        return _count_range(filename, 0, size)
    n = os.cpu_count() or 2
    bounds = [size * i // n for i in range(n + 1)]
    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        counts = pool.map(
            lambda span: _count_range(filename, *span),
            zip(bounds[:-1], bounds[1:]),
        )
    return sum(counts)
