"""Inject: add BED regions of existing paths as new named paths.

A host numpy copy of pollen_tpu/ops/inject.py, over the port's
``bed.FlatBed``. Reference semantics: slow_odgi/inject.py — for each BED
record, cut the graph so the region's endpoints fall on segment seams
(renumbering at most one split segment per cut), then add a path of the
steps lying wholly inside the region. Output is golden-tested against
the spec.

The per-cut rewrites are vectorized over the arena pools; the outer
loop is per BED record (query sets are small).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..bed import FlatBed
from ..flatgfa import GraphArrays
from .transform import _fresh_line_order


def _path_lens(g: GraphArrays, path_id: int) -> Tuple[np.ndarray, np.ndarray]:
    lo, hi = g.path_steps[path_id]
    steps = g.steps[lo:hi]
    lens = g.seg_len[(steps >> 1).astype(np.int64)]
    return steps, lens


def _find_seam(
    g: GraphArrays, path_id: int, offset: int
) -> Optional[Tuple[int, int]]:
    """(segment id, oriented cut position) if ``offset`` falls strictly
    inside a segment of the path; None if already on a seam."""
    steps, lens = _path_lens(g, path_id)
    ends = np.cumsum(lens)
    starts = ends - lens
    if offset == 0 or steps.size == 0:
        return None
    inside = (starts < offset) & (offset < ends)
    idx = np.flatnonzero(inside)
    if idx.size == 0:
        return None
    i = int(idx[0])
    seg = int(steps[i] >> 1)
    cut = offset - int(starts[i])
    if steps[i] & 1:  # reverse step: cut position flips
        cut = int(lens[i]) - cut
    return seg, cut


def _cut_segment(g: GraphArrays, seg: int, cut: int) -> GraphArrays:
    """Split segment ``seg`` at ``cut`` bp, renumbering names as the
    spec does: names > the target's get +1; every path step through the
    target expands to the two pieces."""
    n = g.num_segments
    target_name = int(g.seg_name[seg])

    # New segment table: same order, with the target split in two.
    sizes = np.ones(n, dtype=np.int64)
    sizes[seg] = 2
    first = np.cumsum(sizes) - sizes  # new row of each old seg's first piece

    m = n + 1
    new_names = np.empty(m, dtype=np.int64)
    new_seq = np.empty((m, 2), dtype=np.uint32)
    new_opt = np.zeros((m, 2), dtype=np.uint32)

    keep = np.arange(n) != seg
    rows = first[keep]
    new_names[rows] = np.where(
        g.seg_name[keep] < target_name,
        g.seg_name[keep],
        g.seg_name[keep] + 1,
    )
    new_seq[rows] = g.seg_seq[keep]
    new_opt[rows] = g.seg_optional[keep]

    lo, hi = g.seg_seq[seg]
    new_names[first[seg]] = target_name
    new_seq[first[seg]] = (lo, lo + cut)
    new_names[first[seg] + 1] = target_name + 1
    new_seq[first[seg] + 1] = (lo + cut, hi)

    # Path steps: the target expands to its two pieces (reversed for
    # backward steps); everything else is renumbered in place.
    s_seg = g.step_segs.astype(np.int64)
    s_rev = g.step_reverse.astype(np.int64)
    counts = sizes[s_seg]
    total = int(counts.sum())
    owner = np.repeat(np.arange(g.num_steps), counts)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    cnt = counts[owner]
    rev = s_rev[owner]
    new_ids = first[s_seg[owner]] + np.where(rev == 1, cnt - 1 - offs, offs)
    steps = (new_ids.astype(np.uint32) << np.uint32(1)) | rev.astype(
        np.uint32
    )

    per_path = (
        np.add.reduceat(counts, g.path_steps[:, 0].astype(np.int64))
        if g.num_paths and g.num_steps
        else np.zeros(g.num_paths, np.int64)
    )
    per_path = np.where(g.path_steps[:, 1] > g.path_steps[:, 0], per_path, 0)
    p_end = np.cumsum(per_path)
    path_steps = np.stack([p_end - per_path, p_end], axis=1).astype(np.uint32)

    return dataclasses.replace(
        g,
        seg_name=new_names,
        seg_seq=new_seq,
        seg_optional=new_opt,
        steps=steps,
        path_steps=path_steps,
        # The cut rewrites every path; overlaps are dropped, as in the
        # spec's chop-based renumbering.
        path_overlaps=np.zeros((g.num_paths, 2), np.uint32),
        line_order=_fresh_line_order(
            1 if g.header.size else 0, m, g.num_paths, g.num_links
        ),
    )


def _append_path(
    g: GraphArrays, name: bytes, new_steps: np.ndarray
) -> GraphArrays:
    name_data = np.concatenate(
        [g.name_data, np.frombuffer(name, dtype=np.uint8)]
    )
    name_span = np.concatenate(
        [
            g.path_name,
            [[g.name_data.shape[0], g.name_data.shape[0] + len(name)]],
        ]
    ).astype(np.uint32)
    steps = np.concatenate([g.steps, new_steps.astype(np.uint32)])
    span = np.concatenate(
        [
            g.path_steps,
            [[g.steps.shape[0], g.steps.shape[0] + new_steps.shape[0]]],
        ]
    ).astype(np.uint32)
    overlaps = np.concatenate(
        [g.path_overlaps, [[0, 0]]]
    ).astype(np.uint32)
    return dataclasses.replace(
        g,
        steps=steps,
        path_steps=span,
        path_name=name_span,
        path_overlaps=overlaps,
        name_data=name_data,
        line_order=_fresh_line_order(
            1 if g.header.size else 0,
            g.num_segments,
            g.num_paths + 1,
            g.num_links,
        ),
    )


def _region_steps(g: GraphArrays, path_id: int, lo: int, hi: int) -> np.ndarray:
    """Steps of the path lying wholly inside [lo, hi), stopping at the
    first step that overruns ``hi`` (reference: inject.py track_path)."""
    steps, lens = _path_lens(g, path_id)
    ends = np.cumsum(lens)
    starts = ends - lens
    inside = (starts >= lo) & (ends <= hi)
    # Stop at the first step (at or after the region start) that crosses
    # `hi`; anything after is excluded even if it fits.
    overrun = (starts >= lo) & (ends > hi)
    stop = np.flatnonzero(overrun)
    if stop.size:
        inside &= np.arange(steps.size) < stop[0]
    return steps[inside]


def inject(g: GraphArrays, beds: FlatBed) -> GraphArrays:
    """Inject every BED region as a new path."""
    for i in range(beds.num_entries):
        pname = beds.entry_name(i)
        pid = g.path_id_by_name(pname)
        if pid is None:
            continue  # odgi is silent about absent paths
        lo = int(beds.start[i])
        hi = int(beds.end[i])
        for offset in (lo, hi):
            pid = g.path_id_by_name(pname)
            seam = _find_seam(g, pid, offset)
            if seam is not None:
                g = _cut_segment(g, *seam)
        pid = g.path_id_by_name(pname)
        # BED column 4 names the new path.
        g = _append_path(g, beds.entry_label(i), _region_steps(g, pid, lo, hi))
    return g
