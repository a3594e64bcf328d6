"""Boundary-gather plan, host half only.

A jax-free port of the ingest-time plan of pollen_tpu/kernels/gatherb.py
(``plan_boundary``). The port has no boundary-gather kernel yet; ingest
computes the plan so that the router reads the same ``bnd_w_rows`` /
``bnd2_w_rows`` gates as the reference and routes each graph the same
way (ops/depth.py _masked_impl_costs).
"""

from __future__ import annotations

import dataclasses

import numpy as np

LANES = 128
MIN_WINDOW_ROWS = 8
MAX_WINDOW_ROWS = 512


@dataclasses.dataclass
class BoundaryPlan:
    """Windowed gather plan for ``csum[bounds]`` over sorted bounds."""

    row_start: np.ndarray  # int32[n_tiles] window block index per tile
    loc: np.ndarray  # int32[n_tiles, 128] offset within window
    over_tiles: tuple  # tile indices that overflow the window
    over_bounds: np.ndarray  # int32[T', 128] their raw bound positions
    w_rows: int  # window rows
    n_bounds: int  # true bounds count (result length)
    s_rows: int  # cumsum rows (csum length / 128)


def plan_boundary(bounds: np.ndarray, s_pad: int) -> BoundaryPlan:
    """The gather plan for sorted ``bounds`` against cumsums of padded
    length ``s_pad`` (a multiple of 128), as the reference builds it."""
    if s_pad % LANES:
        raise ValueError(f"s_pad={s_pad} is not a multiple of {LANES}")
    nb = int(bounds.shape[0])
    n_tiles = max(1, -(-nb // LANES))
    nb_pad = n_tiles * LANES
    b = np.concatenate(
        [
            bounds.astype(np.int64),
            np.full(nb_pad - nb, int(bounds[-1]) if nb else 0, np.int64),
        ]
    )
    tiles = b.reshape(n_tiles, LANES)
    first_row = tiles[:, 0] // LANES
    last_row = tiles[:, -1] // LANES
    span = last_row - first_row + 1

    s_rows = s_pad // LANES + 1
    w_rows = MIN_WINDOW_ROWS
    target = max(1, int(np.percentile(span, 90))) if nb else 1
    while w_rows < min(target, MAX_WINDOW_ROWS):
        w_rows *= 2
    w_rows = min(w_rows, MAX_WINDOW_ROWS)

    blk = (first_row // w_rows).astype(np.int32)
    over = np.flatnonzero(last_row // w_rows > blk + 1).astype(np.int32)
    over_bounds = tiles[over].astype(np.int32) if over.size else np.zeros(
        (0, LANES), np.int32
    )
    loc = tiles - blk[:, None].astype(np.int64) * (w_rows * LANES)
    loc = np.clip(loc, 0, 2 * w_rows * LANES - 1).astype(np.int32)
    return BoundaryPlan(
        row_start=blk,
        loc=loc,
        over_tiles=tuple(int(t) for t in over),
        over_bounds=over_bounds,
        w_rows=int(w_rows),
        n_bounds=nb,
        s_rows=s_rows,
    )
