"""Window / interval depth along a path (``depth -b``, ``window-depth``,
``bed-depth``).

A port of pollen_tpu/ops/window_depth.py: host numpy over the port's
unmasked ``seg_depth_with_uniq``, whose depth column is the one device
result it reads. Reference semantics: flatgfa/src/ops/window_depth.rs —
each interval of a path gets the bp-weighted average of the segment
depths it overlaps.
The reference's two-pointer sweep becomes a vectorized expansion: every
(step x window) overlap pair is enumerated with interval arithmetic and
accumulated in step order, reproducing the reference's f64 operation
order exactly (the 4-digit float formatting is sensitive to it).
"""

from __future__ import annotations

import numpy as np

from ..bed import FlatBed, windows_bed
from ..device import TorchGraph
from ..flatgfa import GraphArrays
from .depth import format_float, seg_depth_with_uniq


def _path_steps(g: GraphArrays, path_id: int) -> np.ndarray:
    lo, hi = g.path_steps[path_id]
    return g.steps[lo:hi]


def interval_depth(
    g: GraphArrays, dg: TorchGraph, path_id: int, intervals: FlatBed
) -> np.ndarray:
    """f64 weighted depth per interval (intervals sorted along the path)."""
    depth = seg_depth_with_uniq(dg)[0].cpu().numpy().astype(np.float64)

    steps = _path_steps(g, path_id)
    seg_ids = (steps >> 1).astype(np.int64)
    lens = g.seg_len[seg_ids].astype(np.int64)
    ends = np.cumsum(lens)
    starts = ends - lens

    win_lo = intervals.start.astype(np.int64)
    win_hi = intervals.end.astype(np.int64)
    n_win = intervals.num_entries
    depths = np.zeros(n_win, dtype=np.float64)
    if n_win == 0 or steps.size == 0:
        return depths

    # Window index range overlapped by each step (windows are sorted and
    # non-overlapping along the path).
    first_win = np.searchsorted(win_hi, starts, side="right")
    last_win = np.searchsorted(win_lo, ends, side="left")  # exclusive
    counts = np.maximum(last_win - first_win, 0)

    # Expand to (step, window) pairs, in step order.
    step_of_pair = np.repeat(np.arange(steps.size), counts)
    win_of_pair = (
        np.arange(counts.sum(), dtype=np.int64)
        - np.repeat(np.cumsum(counts) - counts, counts)
        + np.repeat(first_win, counts)
    )

    o_start = np.maximum(starts[step_of_pair], win_lo[win_of_pair])
    o_end = np.minimum(ends[step_of_pair], win_hi[win_of_pair])
    overlap = o_end - o_start
    valid = overlap > 0

    seg_weight = (
        depth[seg_ids[step_of_pair]] * lens[step_of_pair]
    )  # f64, as in the reference's SegmentDepth
    amt = overlap.astype(np.float64) / lens[step_of_pair].astype(np.float64)
    contrib = (seg_weight * amt) / (
        (win_hi[win_of_pair] - win_lo[win_of_pair]).astype(np.float64)
    )
    np.add.at(depths, win_of_pair[valid], contrib[valid])
    return depths


def interval_depth_table(intervals: FlatBed, depths: np.ndarray) -> str:
    lines = []
    for i in range(intervals.num_entries):
        lines.append(
            f"{intervals.entry_name(i).decode()}\t{int(intervals.start[i])}"
            f"\t{int(intervals.end[i])}\t{format_float(float(depths[i]), 4)}"
        )
    return "".join(line + "\n" for line in lines)


def run_window_depth(
    g: GraphArrays, dg: TorchGraph, path_name: str, window: int
) -> str:
    path_id = g.path_id_by_name(path_name.encode())
    if path_id is None:
        raise KeyError(f"path not found: {path_name}")
    lo, hi = g.path_steps[path_id]
    length = int(g.seg_len[(g.steps[lo:hi] >> 1).astype(np.int64)].sum())
    windows = windows_bed(path_name.encode(), 0, length, window)
    depths = interval_depth(g, dg, path_id, windows)
    return interval_depth_table(windows, depths)


def run_bed_depth(g: GraphArrays, dg: TorchGraph, bed: FlatBed) -> str:
    """Depth for intervals from a BED file; all intervals must lie along
    one path (the first entry names it), sorted increasing."""
    path_name = bed.entry_name(0)
    path_id = g.path_id_by_name(path_name)
    if path_id is None:
        raise KeyError(f"path not found: {path_name.decode()}")
    depths = interval_depth(g, dg, path_id, bed)
    return interval_depth_table(bed, depths)
