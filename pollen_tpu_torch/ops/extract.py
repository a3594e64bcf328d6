"""Extract: a neighborhood subgraph around a segment.

A host numpy copy of pollen_tpu/ops/extract.py. Reference semantics:
flatgfa/src/ops/extract.rs — BFS to ``dist`` links from an origin
segment (discovery order assigns the new ids), optional gap-merging of
subpaths, links among included segments, and subpaths of every original
path through the neighborhood (named ``{path}:{start}-{end}`` in bp
coordinates).

The per-segment link scans and per-path walks are vectorized with masks
over the link/step pools; the outer BFS frontier loop is inherently
sequential and small.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..flatgfa import GraphArrays
from .transform import _fresh_line_order


def _discover(
    g: GraphArrays, origin: int, dist: int
) -> Dict[int, int]:
    """old seg id -> new seg id, in the reference's discovery order
    (LIFO frontier, link-pool scan per popped segment)."""
    from_seg = (g.link_from >> 1).astype(np.int64)
    to_seg = (g.link_to >> 1).astype(np.int64)

    seg_map: Dict[int, int] = {origin: 0}
    frontier = [origin]
    for _ in range(dist):
        next_frontier: List[int] = []
        while frontier:
            seg = frontier.pop()
            # All link endpoints incident to `seg`, in pool order.
            hits_from = from_seg == seg
            hits_to = to_seg == seg
            others = np.where(hits_from, to_seg, np.where(hits_to, from_seg, -1))
            for other in others[others >= 0]:
                other = int(other)
                if other not in seg_map:
                    seg_map[other] = len(seg_map)
                    next_frontier.append(other)
        frontier = next_frontier
    return seg_map


def _merge_subpaths(
    g: GraphArrays,
    seg_map: Dict[int, int],
    max_distance: int,
    iterations: int,
) -> None:
    """Gap-merging passes (reference: extract.rs merge_subpaths):
    include the segments of a between-visits gap when the cumulative bp
    position is still within ``max_distance``."""
    lens = g.seg_len
    for _ in range(iterations):
        for p in range(g.num_paths):
            lo, hi = g.path_steps[p]
            steps = g.steps[lo:hi]
            segs = (steps >> 1).astype(np.int64)
            cur_start = 0  # index of the open gap's first step, or None
            have_gap = True
            ignore = True
            length = 0
            for idx in range(segs.shape[0]):
                inside = int(segs[idx]) in seg_map
                if have_gap and inside:
                    if not ignore and length <= max_distance:
                        for s in segs[cur_start:idx]:
                            s = int(s)
                            if s not in seg_map:
                                seg_map[s] = len(seg_map)
                    have_gap = False
                    ignore = False
                elif not have_gap and not inside:
                    cur_start = idx
                    have_gap = True
                length += int(lens[segs[idx]])


def extract(
    g: GraphArrays,
    seg_name: int,
    link_distance: int,
    max_distance_subpaths: int = 300_000,
    num_iterations: int = 6,
) -> GraphArrays:
    names = g.seg_id_by_name()
    origin = int(names.lookup(np.array([seg_name], dtype=np.int64))[0])

    seg_map = _discover(g, origin, link_distance)
    _merge_subpaths(g, seg_map, max_distance_subpaths, num_iterations)

    old_ids = np.fromiter(seg_map.keys(), dtype=np.int64)
    m = old_ids.shape[0]

    # Segment table in discovery order, sequences re-packed.
    seq_lens = g.seg_len[old_ids]
    seq_parts = [g.seq_data[lo:hi] for lo, hi in g.seg_seq[old_ids]]
    seq_data = (
        np.concatenate(seq_parts) if seq_parts else np.zeros(0, np.uint8)
    )
    ends = np.cumsum(seq_lens)
    seg_seq = np.stack([ends - seq_lens, ends], axis=1).astype(np.uint32)

    opt_parts = [g.optional_data[lo:hi] for lo, hi in g.seg_optional[old_ids]]
    optional_data = (
        np.concatenate(opt_parts) if opt_parts else np.zeros(0, np.uint8)
    )
    opt_lens = (g.seg_optional[old_ids, 1] - g.seg_optional[old_ids, 0]).astype(
        np.int64
    )
    o_ends = np.cumsum(opt_lens)
    seg_optional = np.stack([o_ends - opt_lens, o_ends], axis=1).astype(
        np.uint32
    )

    # Links whose endpoints are both included, translated.
    remap = np.full(g.num_segments, -1, dtype=np.int64)
    remap[old_ids] = np.arange(m)
    lf = remap[(g.link_from >> 1).astype(np.int64)]
    lt = remap[(g.link_to >> 1).astype(np.int64)]
    keep = (lf >= 0) & (lt >= 0)
    link_from = (
        (lf[keep].astype(np.uint32) << np.uint32(1)) | (g.link_from[keep] & 1)
    )
    link_to = (
        (lt[keep].astype(np.uint32) << np.uint32(1)) | (g.link_to[keep] & 1)
    )
    link_overlap = g.link_overlap[keep]

    # Subpaths crossing the neighborhood (reference: find_subpaths).
    out_steps: List[np.ndarray] = []
    path_rows: List[tuple] = []  # (name bytes, n_steps)
    for p in range(g.num_paths):
        lo, hi = g.path_steps[p]
        steps = g.steps[lo:hi]
        segs = (steps >> 1).astype(np.int64)
        inside = remap[segs] >= 0
        lens = g.seg_len[segs].astype(np.int64)
        pos = np.cumsum(lens) - lens  # bp start of each step

        translated = (
            (remap[segs].clip(0).astype(np.uint32) << np.uint32(1))
            | (steps & 1)
        )
        # Maximal runs of included steps.
        bounded = np.concatenate(([False], inside, [False]))
        starts = np.flatnonzero(bounded[1:] & ~bounded[:-1])
        stops = np.flatnonzero(~bounded[1:] & bounded[:-1])
        base = g.path_name_bytes(p)
        total = int(lens.sum())
        for a, b in zip(starts, stops):
            bp_lo = int(pos[a])
            bp_hi = int(pos[b]) if b < segs.shape[0] else total
            name = base + f":{bp_lo}-{bp_hi}".encode()
            out_steps.append(translated[a:b])
            path_rows.append((name, b - a))

    steps_arr = (
        np.concatenate(out_steps).astype(np.uint32)
        if out_steps
        else np.zeros(0, np.uint32)
    )
    counts = np.array([c for _, c in path_rows], dtype=np.int64)
    p_end = np.cumsum(counts) if counts.size else np.zeros(0, np.int64)
    path_steps = (
        np.stack([p_end - counts, p_end], axis=1).astype(np.uint32)
        if counts.size
        else np.zeros((0, 2), np.uint32)
    )
    name_blob = b"".join(nm for nm, _ in path_rows)
    name_lens = np.array([len(nm) for nm, _ in path_rows], dtype=np.int64)
    n_end = np.cumsum(name_lens) if name_lens.size else np.zeros(0, np.int64)
    path_name = (
        np.stack([n_end - name_lens, n_end], axis=1).astype(np.uint32)
        if name_lens.size
        else np.zeros((0, 2), np.uint32)
    )

    return dataclasses.replace(
        g,
        seg_name=g.seg_name[old_ids],
        seg_seq=seg_seq,
        seg_optional=seg_optional,
        seq_data=seq_data,
        optional_data=optional_data,
        link_from=link_from,
        link_to=link_to,
        link_overlap=link_overlap,
        steps=steps_arr,
        path_steps=path_steps,
        path_name=path_name,
        path_overlaps=np.zeros((counts.shape[0], 2), np.uint32),
        name_data=np.frombuffer(name_blob, dtype=np.uint8).copy()
        if name_blob
        else np.zeros(0, np.uint8),
        line_order=_fresh_line_order(
            1 if g.header.size else 0,
            m,
            counts.shape[0],
            link_from.shape[0],
        ),
    )
