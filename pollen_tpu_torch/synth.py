"""Seeded synthetic pangenome graphs and read sets for benchmarks and
smoke runs.

A jax-free copy of the reference bench's synthesis (bench.py
``synth_device_graph``): Zipf(1.3) segment popularity over a flat step
list cut into equal paths, 10% reverse steps, segment lengths 1-31 bp,
``numpy.random.default_rng(seed)``. Paths are named ``p0``, ``p1``, ...
so that name-based queries (``depth -d -s``) reach them; the names do
not change the index or the routing.

``synth_gaf`` writes a seeded GAF read set of a graph the way the
reference bench suite makes one (benchsuite/runner.py ``ensure_gaf``:
each read a random sub-walk of a random path, with a random [start,
end) inside its bp span), as one numpy pass with no per-read loop.
"""

from __future__ import annotations

import numpy as np

from .flatgfa import GraphArrays


def synth_graph(
    n_steps: int, n_segs: int, n_paths: int, seed: int = 8
) -> GraphArrays:
    rng = np.random.default_rng(seed)
    pop = rng.zipf(1.3, size=n_steps).astype(np.int64)
    segs = (pop - 1) % n_segs
    rev = rng.random(n_steps) < 0.1
    steps = (segs.astype(np.uint32) << np.uint32(1)) | rev.astype(np.uint32)

    bounds = np.linspace(0, n_steps, n_paths + 1).astype(np.uint32)
    path_steps = np.stack([bounds[:-1], bounds[1:]], axis=1)

    seg_lens = rng.integers(1, 32, size=n_segs).astype(np.uint32)
    seq_bounds = np.concatenate(([0], np.cumsum(seg_lens))).astype(np.uint32)
    seg_seq = np.stack([seq_bounds[:-1], seq_bounds[1:]], axis=1)

    names = [f"p{i}".encode() for i in range(n_paths)]
    name_ends = np.cumsum([len(b) for b in names]).astype(np.uint32)
    path_name = np.stack(
        [np.concatenate(([0], name_ends[:-1])).astype(np.uint32), name_ends],
        axis=1,
    )
    return GraphArrays(
        header=np.zeros(0, np.uint8),
        seg_name=np.arange(1, n_segs + 1, dtype=np.int64),
        seg_seq=seg_seq,
        seg_optional=np.zeros((n_segs, 2), np.uint32),
        path_name=path_name,
        path_steps=path_steps,
        path_overlaps=np.zeros((n_paths, 2), np.uint32),
        link_from=np.zeros(0, np.uint32),
        link_to=np.zeros(0, np.uint32),
        link_overlap=np.zeros((0, 2), np.uint32),
        steps=steps,
        seq_data=np.zeros(int(seq_bounds[-1]), np.uint8),
        overlaps=np.zeros((0, 2), np.uint32),
        alignment=np.zeros(0, np.uint32),
        name_data=np.frombuffer(b"".join(names), np.uint8).copy(),
        optional_data=np.zeros(0, np.uint8),
        line_order=np.zeros(0, np.uint8),
    )


def _ascii_ints(values: np.ndarray):
    """Decimal text of non-negative ints: (bytes uint8[*], lengths)."""
    values = values.astype(np.int64)
    ndig = np.ones(values.shape[0], np.int64)
    for d in range(1, 19):
        ndig += values >= 10**d
    ends = np.cumsum(ndig)
    data = np.empty(int(ends[-1]) if ends.size else 0, np.uint8)
    for d in range(int(ndig.max()) if ndig.size else 0):
        sel = ndig > d
        data[ends[sel] - 1 - d] = 48 + (values[sel] // 10**d) % 10
    return data, ndig


def _interleave(parts):
    """Row i of the result is parts[0]'s row i, then parts[1]'s, ...;
    each part is (bytes, lengths of its rows), rows in order."""
    lens = np.stack([ln for _, ln in parts])  # (K, R)
    before = np.cumsum(lens, axis=0) - lens  # offset inside a row
    row_start = np.cumsum(lens.sum(0)) - lens.sum(0)
    out = np.empty(int(lens.sum()), np.uint8)
    for (data, ln), off in zip(parts, before):
        src_start = np.cumsum(ln) - ln
        shift = np.repeat(row_start + off - src_start, ln)
        out[np.arange(data.shape[0]) + shift] = data
    return out, lens.sum(0)


def _const(text: bytes, rows: int):
    return (
        np.tile(np.frombuffer(text, np.uint8), rows),
        np.full(rows, len(text), np.int64),
    )


def synth_gaf(
    g: GraphArrays, n_reads: int, seed: int = 17, max_steps: int = 31
) -> bytes:
    """GAF text of ``n_reads`` reads of ``g``: read ``i`` is a sub-walk
    of 1 to ``max_steps`` steps (at most its path's) of a random path
    with at least one step, and a random [start, end) inside the walk's
    bp span (start < end unless the span is empty)."""
    rng = np.random.default_rng(seed)
    lo = g.path_steps[:, 0].astype(np.int64)
    n_path = g.path_steps[:, 1].astype(np.int64) - lo
    ok = np.flatnonzero(n_path > 0)
    p = ok[rng.integers(0, ok.shape[0], n_reads)]
    k = np.minimum(rng.integers(1, max_steps + 1, n_reads), n_path[p])
    first = lo[p] + (rng.random(n_reads) * (n_path[p] - k + 1)).astype(
        np.int64
    )
    k_end = np.cumsum(k)
    idx = np.repeat(first - (k_end - k), k) + np.arange(int(k_end[-1]))
    steps = g.steps[idx].astype(np.int64)
    seg = steps >> 1
    bp = g.seg_len[seg].astype(np.int64)
    total = np.add.reduceat(bp, k_end - k)
    start = (rng.random(n_reads) * np.maximum(total, 1)).astype(np.int64)
    start = np.minimum(start, np.maximum(total - 1, 0))
    end = start + 1 + (rng.random(n_reads) * (total - start)).astype(np.int64)
    end = np.minimum(end, np.maximum(total, 1))

    # Path text: one ">name" or "<name" token a step.
    arrows = np.where(steps & 1, ord("<"), ord(">")).astype(np.uint8)
    tokens, tok_len = _interleave(
        [(arrows, np.ones(steps.shape[0], np.int64)),
         _ascii_ints(g.seg_name[seg])]
    )
    tok_end = np.cumsum(tok_len)[k_end - 1]
    path_len = np.diff(np.concatenate(([0], tok_end)))
    tot = _ascii_ints(total)
    parts = [
        _const(b"read", n_reads), _ascii_ints(np.arange(n_reads)),
        _const(b"\t", n_reads), tot, _const(b"\t0\t", n_reads), tot,
        _const(b"\t+\t", n_reads), (tokens, path_len),
        _const(b"\t", n_reads), tot, _const(b"\t", n_reads),
        _ascii_ints(start), _const(b"\t", n_reads), _ascii_ints(end),
        _const(b"\t1\t1\t60\n", n_reads),
    ]
    return _interleave(parts)[0].tobytes()
