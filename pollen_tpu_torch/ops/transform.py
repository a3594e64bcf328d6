"""Graph transforms over the flat arena: crush, flip, chop.

A port of pollen_tpu/ops/transform.py. Each transform is a vectorized
count-then-allocate rebuild of the affected pools (no per-entity Python
loops); flip's orientation vote, which scales with the step list, runs
on the graph's device. Output text is byte-identical to the executable
spec (reference semantics: slow_odgi/{crush,flip,chop}.py,
flatgfa/src/ops/chop.rs).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..device import TorchGraph, bounded_segment_sum
from ..flatgfa import GraphArrays, ragged_gather

_N = ord("N")


def _drop_path_overlaps(g: GraphArrays) -> dict:
    return dict(path_overlaps=np.zeros((g.num_paths, 2), np.uint32))


def _fresh_line_order(n_h: int, n_s: int, n_p: int, n_l: int) -> np.ndarray:
    """Normalized line order for a rebuilt graph: H, S*, P*, L*."""
    return np.concatenate(
        [
            np.zeros(n_h, np.uint8),
            np.ones(n_s, np.uint8),
            np.full(n_p, 2, np.uint8),
            np.full(n_l, 3, np.uint8),
        ]
    )


# ---------------------------------------------------------------------------
# crush
# ---------------------------------------------------------------------------


def crush(g: GraphArrays) -> GraphArrays:
    """Collapse within-segment runs of N to a single N."""
    starts = g.seg_seq[:, 0].astype(np.int64)
    lens = g.seg_len
    # Bytes of all segments, concatenated in id order (handles shared or
    # out-of-order spans, e.g. post-chop arenas).
    seq = ragged_gather(g.seq_data, starts, lens)
    bounds = np.concatenate(([0], np.cumsum(lens)))

    is_n = seq == _N
    prev_n = np.concatenate(([False], is_n[:-1]))
    # A position starts a segment if it's at a segment boundary.
    seg_start = np.zeros(seq.shape[0] + 1, dtype=bool)
    seg_start[bounds[:-1]] = True
    keep = ~(is_n & prev_n & ~seg_start[: seq.shape[0]])

    new_seq = seq[keep]
    kept_per_seg = np.add.reduceat(
        keep.astype(np.int64), bounds[:-1]
    ) if g.num_segments else np.zeros(0, np.int64)
    kept_per_seg = np.where(lens == 0, 0, kept_per_seg)
    new_ends = np.cumsum(kept_per_seg)
    new_spans = np.stack([new_ends - kept_per_seg, new_ends], axis=1).astype(
        np.uint32
    )

    return dataclasses.replace(
        g,
        seq_data=new_seq,
        seg_seq=new_spans,
        **_drop_path_overlaps(g),
    )


# ---------------------------------------------------------------------------
# flip
# ---------------------------------------------------------------------------


def _reverse_heavy_paths(dg: TorchGraph) -> torch.Tensor:
    """bool[P] on the graph's device: does the path cover more reverse
    than forward bp? (int64 bp sums)"""
    lens = dg.seg_len[dg.steps >> 1].long()
    rev = dg.steps & 1
    rev_bp = bounded_segment_sum(lens * rev, dg.path_bounds)
    fwd_bp = bounded_segment_sum(lens * (1 - rev), dg.path_bounds)
    return rev_bp > fwd_bp


def _dedup_links(
    link_from: np.ndarray,
    link_to: np.ndarray,
    overlap_key: np.ndarray,
) -> np.ndarray:
    """Indices of first occurrences, treating a link and its reverse
    (same overlap) as duplicates; order preserved."""
    fwd = (link_from.astype(np.uint64) << np.uint64(32)) | link_to.astype(
        np.uint64
    )
    r_from = link_to ^ 1
    r_to = link_from ^ 1
    rev = (r_from.astype(np.uint64) << np.uint64(32)) | r_to.astype(np.uint64)
    canon = np.minimum(fwd, rev)
    combo = np.stack([canon, overlap_key.astype(np.uint64)], axis=1)
    _, first_idx = np.unique(combo, axis=0, return_index=True)
    return np.sort(first_idx)


def _overlap_keys(g: GraphArrays, extra_zero_m: int = 0) -> np.ndarray:
    """An equality key per link overlap (factorized op sequences), with
    ``extra_zero_m`` trailing entries keyed as the literal ``0M``."""
    keys = np.zeros(g.num_links + extra_zero_m, dtype=np.int64)
    seen: dict = {}
    for i, (lo, hi) in enumerate(g.link_overlap):
        parts = []
        for e in range(lo, hi):
            alo, ahi = g.overlaps[e]
            parts.append(tuple(g.alignment[alo:ahi].tolist()))
        keys[i] = seen.setdefault(tuple(parts), len(seen))
    if extra_zero_m:
        keys[g.num_links :] = seen.setdefault(((0,),), len(seen))
    return keys


def flip(g: GraphArrays, dg: TorchGraph) -> Tuple[GraphArrays, np.ndarray]:
    """Flip reverse-heavy paths (renamed ``{name}_inv``), regenerate and
    deduplicate links. Returns (new arena, original-name sort keys) —
    the spec sorts emitted paths by their *original* names."""
    flipped = _reverse_heavy_paths(dg).cpu().numpy()

    # Rewrite steps: flipped paths reverse their span and toggle bits.
    steps = np.asarray(g.steps).copy()
    spans = g.path_steps
    for p in np.flatnonzero(flipped):
        lo, hi = spans[p]
        steps[lo:hi] = steps[lo:hi][::-1] ^ 1

    # Rename flipped paths.
    names = [g.path_name_bytes(p) for p in range(g.num_paths)]
    new_names = [
        nm + b"_inv" if flipped[p] else nm for p, nm in enumerate(names)
    ]
    name_data = np.frombuffer(b"".join(new_names), dtype=np.uint8)
    lens = np.array([len(n) for n in new_names], dtype=np.uint32)
    ends = np.cumsum(lens, dtype=np.uint32)
    path_name = np.stack([ends - lens, ends], axis=1)

    # Links that make flipped paths valid: adjacent step pairs.
    added_from, added_to = [], []
    for p in np.flatnonzero(flipped):
        lo, hi = spans[p]
        if hi - lo >= 2:
            added_from.append(steps[lo : hi - 1])
            added_to.append(steps[lo + 1 : hi])
    if added_from:
        add_f = np.concatenate(added_from).astype(np.uint32)
        add_t = np.concatenate(added_to).astype(np.uint32)
    else:
        add_f = np.zeros(0, np.uint32)
        add_t = np.zeros(0, np.uint32)

    # The added links all carry the no-op overlap "0M"; give it a fresh
    # alignment entry.
    zero_m = np.array([0], dtype=np.uint32)  # (0 << 8) | M
    alignment = np.concatenate([g.alignment, zero_m])
    zero_span = np.array(
        [[g.overlaps.shape[0], g.overlaps.shape[0] + 1]], np.uint32
    )
    overlaps = np.concatenate([g.overlaps, zero_span], axis=0)
    n_old = g.num_links
    link_from = np.concatenate([g.link_from, add_f])
    link_to = np.concatenate([g.link_to, add_t])
    ov_idx = np.concatenate(
        [
            g.link_overlap,
            np.repeat(
                np.array([[g.overlaps.shape[0], g.overlaps.shape[0] + 1]]),
                add_f.shape[0],
                axis=0,
            ),
        ]
    ).astype(np.uint32)

    del n_old
    olap_keys = _overlap_keys(g, extra_zero_m=add_f.shape[0])
    keep = _dedup_links(link_from, link_to, olap_keys)

    out = dataclasses.replace(
        g,
        steps=steps,
        path_name=path_name,
        name_data=name_data,
        link_from=link_from[keep],
        link_to=link_to[keep],
        link_overlap=ov_idx[keep],
        overlaps=overlaps,
        alignment=alignment,
        line_order=_fresh_line_order(
            1 if g.header.size else 0,
            g.num_segments,
            g.num_paths,
            keep.shape[0],
        ),
        **_drop_path_overlaps(g),
    )
    return out, np.array([n.decode() for n in names])


# ---------------------------------------------------------------------------
# chop
# ---------------------------------------------------------------------------


def chop(g: GraphArrays, limit: int, with_links: bool = False) -> GraphArrays:
    """Split segments to at most ``limit`` bp, renumbering sequentially
    from 1 and expanding path steps; sequence bytes are shared with the
    input arena (same trick as the reference: cli/main.rs:145-157)."""
    lens = g.seg_len
    pieces = np.maximum((lens + limit - 1) // limit, 0).astype(np.int64)
    first_new = np.cumsum(pieces) - pieces  # new id of each old seg's run

    m = int(pieces.sum())
    # New segment spans: old_start + k*limit, clipped at old_end.
    owner = np.repeat(np.arange(g.num_segments), pieces)
    k = np.arange(m, dtype=np.int64) - first_new[owner]
    new_lo = g.seg_seq[owner, 0].astype(np.int64) + k * limit
    new_hi = np.minimum(new_lo + limit, g.seg_seq[owner, 1].astype(np.int64))
    seg_seq = np.stack([new_lo, new_hi], axis=1).astype(np.uint32)
    seg_name = np.arange(1, m + 1, dtype=np.int64)

    # Path steps: each old step expands to its segment's pieces, in
    # reverse order for backward steps.
    s_seg = g.step_segs.astype(np.int64)
    s_rev = g.step_reverse.astype(np.int64)
    counts = pieces[s_seg]
    total = int(counts.sum())
    owner_step = np.repeat(np.arange(g.num_steps), counts)
    offs = (
        np.arange(total, dtype=np.int64)
        - np.repeat(np.cumsum(counts) - counts, counts)
    )
    base = first_new[s_seg[owner_step]]
    cnt = counts[owner_step]
    rev = s_rev[owner_step]
    new_seg_ids = base + np.where(rev == 1, cnt - 1 - offs, offs)
    steps = (new_seg_ids.astype(np.uint32) << np.uint32(1)) | rev.astype(
        np.uint32
    )

    per_path = np.add.reduceat(
        counts, g.path_steps[:, 0].astype(np.int64)
    ) if g.num_paths and g.num_steps else np.zeros(g.num_paths, np.int64)
    per_path = np.where(
        g.path_steps[:, 1] > g.path_steps[:, 0], per_path, 0
    )
    p_end = np.cumsum(per_path)
    path_steps = np.stack([p_end - per_path, p_end], axis=1).astype(np.uint32)

    if with_links:
        # Bridge links inside each chopped segment, then rewired old links
        # (reference: ops/chop.rs link_forward + the from/to remapping).
        multi = np.flatnonzero(pieces > 1)
        bridge_counts = pieces[multi] - 1
        nb = int(bridge_counts.sum())
        b_owner = np.repeat(multi, bridge_counts)
        b_off = np.arange(nb) - np.repeat(
            np.cumsum(bridge_counts) - bridge_counts, bridge_counts
        )
        b_from = (first_new[b_owner] + b_off).astype(np.uint32) << np.uint32(1)
        b_to = (first_new[b_owner] + b_off + 1).astype(np.uint32) << np.uint32(
            1
        )

        of_seg = (g.link_from >> 1).astype(np.int64)
        ot_seg = (g.link_to >> 1).astype(np.int64)
        of_rev = (g.link_from & 1).astype(np.int64)
        ot_rev = (g.link_to & 1).astype(np.int64)
        nf_seg = np.where(
            of_rev == 0, first_new[of_seg] + pieces[of_seg] - 1, first_new[of_seg]
        )
        nt_seg = np.where(
            ot_rev == 0, first_new[ot_seg], first_new[ot_seg] + pieces[ot_seg] - 1
        )
        link_from = np.concatenate(
            [b_from, (nf_seg.astype(np.uint32) << np.uint32(1)) | of_rev.astype(np.uint32)]
        )
        link_to = np.concatenate(
            [b_to, (nt_seg.astype(np.uint32) << np.uint32(1)) | ot_rev.astype(np.uint32)]
        )
        link_overlap = np.zeros((link_from.shape[0], 2), np.uint32)
    else:
        link_from = np.zeros(0, np.uint32)
        link_to = np.zeros(0, np.uint32)
        link_overlap = np.zeros((0, 2), np.uint32)

    return dataclasses.replace(
        g,
        seg_name=seg_name,
        seg_seq=seg_seq,
        seg_optional=np.zeros((m, 2), np.uint32),
        steps=steps,
        path_steps=path_steps,
        link_from=link_from,
        link_to=link_to,
        link_overlap=link_overlap,
        line_order=_fresh_line_order(
            1 if g.header.size else 0, m, g.num_paths, link_from.shape[0]
        ),
        **_drop_path_overlaps(g),
    )
