"""Boundary gather (K7): per-segment differences of cumsums at sorted
bounds, and the reference's ingest-time plan.

    out[i] = ex[bounds[i + 1]] - ex[bounds[i]],  ex[b] = csum[b - 1], ex[0] = 0

for one or two int32 cumsums of one length in one launch; a bound may
equal the cumsum's length. A port of pollen_tpu/kernels/gatherb.py
``gather_boundary`` and ``boundary_diff_planned``: the CUDA kernel
(``csrc/scan.cu`` pollen_boundary_diff) reads ``seg_bounds`` or
``run_seg_bounds`` directly and is exact in int32 at every size, so the
reference's windows, its f32 limit of < 2^24 steps and its overflow-tile
fix-up do not apply. The wrapper runs the plain version only on a CPU
tensor.

``plan_boundary`` (host, jax-free) stays only because ingest computes
the plan's window rows: the router reads the same ``bnd_w_rows`` /
``bnd2_w_rows`` gates as the reference and routes each graph the same
way (ops/depth.py _masked_impl_costs).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build

LANES = 128
MIN_WINDOW_ROWS = 8
MAX_WINDOW_ROWS = 512

# Launch count of the CUDA kernel (plain-version calls do not count).
launches = {"boundary": 0}


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


def gather_boundary_diff_plain(
    csums: Sequence[torch.Tensor], bounds: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`gather_boundary_diff`."""
    from ..device import boundary_diff

    return tuple(boundary_diff(c, bounds) for c in csums)


def gather_boundary_diff(
    csums: Sequence[torch.Tensor], bounds: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Per-range sums, int32[len(bounds) - 1] each, for one or two
    inclusive int32 cumsums of one length and sorted int32 bounds in
    [0, length]. CUDA: csrc/scan.cu pollen_boundary_diff (a bound
    outside that range is clamped there, never read past the cumsum)."""
    if not 1 <= len(csums) <= 2:
        raise ValueError(f"need one or two cumsums, got {len(csums)}")
    length = csums[0].shape[0]
    for t in (*csums, bounds):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError("cumsums and bounds must be contiguous 1-D int32")
        if t.device != bounds.device:
            raise ValueError("cumsums and bounds must share one device")
    if any(c.shape[0] != length for c in csums) or bounds.shape[0] < 1:
        raise ValueError("cumsums of one length and at least one bound")
    device = bounds.device
    if device.type == "cpu":
        return gather_boundary_diff_plain(csums, bounds)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    n = bounds.shape[0] - 1
    outs = torch.empty((len(csums), n), dtype=torch.int32, device=device)
    c1 = csums[1].data_ptr() if len(csums) == 2 else None
    o1 = outs[1].data_ptr() if len(csums) == 2 else None
    _build.check(
        "pollen_boundary_diff",
        _build.load().pollen_boundary_diff(
            csums[0].data_ptr(), c1, length, bounds.data_ptr(), n,
            outs[0].data_ptr(), o1,
            torch.cuda.current_stream(device).cuda_stream,
        ),
    )
    if n:
        launches["boundary"] += 1
    return tuple(outs)
