"""Seeded synthetic pangenome graphs for benchmarks and smoke runs.

A jax-free copy of the reference bench's synthesis (bench.py
``synth_device_graph``): Zipf(1.3) segment popularity over a flat step
list cut into equal paths, 10% reverse steps, segment lengths 1-31 bp,
``numpy.random.default_rng(seed)``. Paths are named ``p0``, ``p1``, ...
so that name-based queries (``depth -d -s``) reach them; the names do
not change the index or the routing.
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
