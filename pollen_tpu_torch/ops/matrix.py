"""Sparse-matrix rendering (``matrix-adj``).

The port's own copy of pollen_tpu/ops/matrix.py (reference semantics:
slow_odgi/matrix.py). Output order mirrors the spec's adjacency
iteration: links grouped by source handle — segment id order, forward
orientation before reverse, insertion order within a handle — with each
link printed in both directions and no deduplication (odgi quirks
preserved). The grouping is a vectorized stable sort over (src segment,
src orientation).
"""

from __future__ import annotations

import numpy as np

from ..flatgfa import GraphArrays


def run_matrix(g: GraphArrays) -> str:
    top = int(g.seg_name.max()) if g.num_segments else 0
    lines = [f"{top} {top} {2 * g.num_links}"]
    if g.num_links:
        src_seg = (g.link_from >> 1).astype(np.int64)
        src_rev = (g.link_from & 1).astype(np.int64)
        order = np.lexsort(
            (np.arange(g.num_links), src_rev, src_seg)
        )
        a = g.seg_name[src_seg[order]].astype("U20")
        b = g.seg_name[(g.link_to[order] >> 1).astype(np.int64)].astype(
            "U20"
        )
        for x, y in zip(a, b):
            lines.append(f"{x} {y} 1")
            lines.append(f"{y} {x} 1")
    return "\n".join(lines) + "\n"
