"""Byte-range-sharded GFA parsing for multi-host ingest.

A copy of pollen_tpu/parallel/loader.py on the port's own arena code
(``pollen_tpu_torch/flatgfa.py``). It does no device work.

Reference analogue: the rayon ``MemchrSplit`` newline splitter
(flatgfa/src/memfile.rs:33-117) generalized to per-host byte ranges, as
SURVEY.md §5 prescribes — but with the parse *work* actually
distributed: each host parses only its own byte range into range-local
pools (``flatgfa._parse_gfa_deferred``), links/paths resolve against
the exchanged global segment-name table, and the final arena is a pure
concatenation of parsed pools (``flatgfa.merge_resolved``) —
byte-identical to a single-process parse of the whole file.

Per-host work: O(file / n_hosts) text parsing + O(segment table) for
the name exchange + array-speed concatenation. No host ever reads or
re-parses another host's text; split points come from size-only seeks
plus a small window read per boundary.

In a real multi-host job each host calls :func:`parse_range_file` for
its own range (the ranges are computed identically everywhere from the
file size) and exchanges pools (see ``distributed.ingest``); a world
of one rank runs the same code paths in one process over all ranges
(:func:`load_gfa_sharded`).
"""

from __future__ import annotations

import io
from typing import Dict, List, Tuple

import numpy as np

from ..flatgfa import (
    DeferredArrays,
    GraphArrays,
    NameIndex,
    ResolvedArrays,
    _parse_gfa_deferred,
    merge_resolved,
    resolve_deferred,
)

# Window read size when snapping a split point to the next newline.
_SNAP_WINDOW = 1 << 20


def split_ranges_file(filename: str, n: int) -> List[Tuple[int, int]]:
    """Split a file into n newline-aligned byte ranges WITHOUT reading
    it: one seek for the size, then at most a few window reads per
    boundary to find the next newline. Every host computes identical
    ranges from the same (filename, n)."""
    with open(filename, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        if size == 0:
            return [(0, 0)] * n
        bounds = [0]
        for i in range(1, n):
            target = (size * i) // n
            pos = max(target, bounds[-1])
            nl = -1
            while pos < size:
                f.seek(pos)
                window = f.read(min(_SNAP_WINDOW, size - pos))
                hit = window.find(b"\n")
                if hit >= 0:
                    nl = pos + hit
                    break
                pos += len(window)
            bounds.append(size if nl < 0 else nl + 1)
        bounds.append(size)
    return list(zip(bounds[:-1], bounds[1:]))


def split_ranges(size: int, n: int, data: bytes) -> List[Tuple[int, int]]:
    """In-memory variant of :func:`split_ranges_file` (same boundaries:
    snap forward to the next newline so no line straddles ranges)."""
    if size == 0:
        return [(0, 0)] * n
    bounds = [0]
    for i in range(1, n):
        target = max((size * i) // n, bounds[-1])
        nl = data.find(b"\n", target)
        bounds.append(size if nl < 0 else nl + 1)
    bounds.append(size)
    return list(zip(bounds[:-1], bounds[1:]))


def parse_range_file(filename: str, lo: int, hi: int) -> DeferredArrays:
    """Phase 1 for one host: read and parse ONLY [lo, hi) of the file
    into range-local pools with unresolved segment references."""
    with open(filename, "rb") as f:
        f.seek(lo)
        return _parse_gfa_deferred(f.read(hi - lo))


def resolved_to_blob(r: ResolvedArrays) -> bytes:
    """Serialize a resolved range (deferred pools + resolved handles;
    the raw name tokens are dropped — they are dead after phase 2)."""
    buf = io.BytesIO()
    arrays = {k: v for k, v in r.d.__dict__.items()}
    for k in ("from_names", "to_names", "step_names", "step_rev",
              "from_rev", "to_rev"):
        arrays.pop(k, None)
    arrays["link_from"] = r.link_from
    arrays["link_to"] = r.link_to
    arrays["steps"] = r.steps
    np.savez(buf, **arrays)
    return buf.getvalue()


def resolved_from_blob(blob: bytes) -> ResolvedArrays:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        fields: Dict[str, np.ndarray] = {k: z[k] for k in z.files}
    link_from = fields.pop("link_from")
    link_to = fields.pop("link_to")
    steps = fields.pop("steps")
    empty64 = np.zeros(0, np.int64)
    emptyb = np.zeros(0, bool)
    d = DeferredArrays(
        from_names=empty64,
        from_rev=emptyb,
        to_names=empty64,
        to_rev=emptyb,
        step_names=empty64,
        step_rev=np.zeros(0, np.uint32),
        **fields,
    )
    return ResolvedArrays(d=d, link_from=link_from, link_to=link_to, steps=steps)


def load_gfa_sharded(filename: str, n_ranges: int) -> GraphArrays:
    """Load a GFA by splitting it into n byte ranges and merging.

    The multi-host flow in one process; each range's parse
    is independent work (one host each in a distributed job), and the
    result is byte-identical to a direct parse of the whole file.
    """
    ranges = split_ranges_file(filename, n_ranges)
    deferred = [parse_range_file(filename, lo, hi) for lo, hi in ranges]
    names = NameIndex(np.concatenate([d.seg_name for d in deferred]))
    return merge_resolved([resolve_deferred(d, names) for d in deferred])
