"""The least time the card could take for one call of a route, and the
peak it is counted at.

A call reads, each once, the resident index tensors of its route and
the masks it is given, and writes the int32 answers, depth and uniq for
every segment of every mask. Of the crossing matrix it reads only the
rows that hold a path that one of the call's masks selects (K2 and K5
skip the others; a nibble row holds paths 2r and 2r + 1). At the H100
SXM's 3.35 TB/s of HBM (its data sheet) the least time is those bytes
over that rate; the routes do integer adds and compares only, far below
any compute peak, so bytes bound them. The same count as
``chip_smoke.py`` ``bound``, for a whole call: intermediates (per-class
parts, scan cumsums, the int32 copy of a mask) are not counted, since a
call that fused its stages would not write them.

The index tensors are read from the resident graph's sizes when the
traced calls run, so a later change of layout cannot leave the count
stale. ``ell_order`` is not counted: the answer's un-permute needs it,
but on the host.
"""

from __future__ import annotations

import numpy as np

HBM_BPS = 3.35e12

ROUTE_TENSORS = {
    "ell": ("cross_ell", "cross_ell2", "cross_ell3", "ell_heavy",
            "ell_heavy_res", "ell_heavy_res_col"),
    "cross": ("cross_matrix", "cross_res", "cross_res_seg"),
    "scan": ("step_path_sorted", "run_start", "seg_bounds"),
    "runs": ("run_path", "run_count", "run_seg_bounds"),
}
# The router's "xla" route runs the scan.
ROUTE_TENSORS["xla"] = ROUTE_TENSORS["scan"]


def selected_rows(masks: np.ndarray, rows: int, per_row: int) -> int:
    """Rows of a crossing matrix (``per_row`` paths a row) that hold a
    path that one of ``masks`` (Q, P) selects."""
    sel = np.atleast_2d(np.asarray(masks, bool)).any(axis=0)[: rows * per_row]
    padded = np.zeros(rows * per_row, bool)
    padded[: sel.size] = sel
    return int(padded.reshape(rows, per_row).any(axis=1).sum())


def tensor_bytes(dg, name: str, masks: np.ndarray) -> int:
    t = getattr(dg, name)
    if name == "cross_matrix" and t.numel():
        per_row = 2 if dg.cross_nibble else 1
        return selected_rows(masks, t.shape[0], per_row) * t.shape[1] * t.element_size()
    return t.numel() * t.element_size()


def call_bytes(dg, route: str, masks: np.ndarray) -> int:
    """A call's bytes: the route's index tensors once, the call's bool
    masks (Q, P) a byte a path, and two int32 answers of N segments a
    mask."""
    masks = np.atleast_2d(np.asarray(masks, bool))
    q, p = masks.shape
    index = sum(tensor_bytes(dg, f, masks) for f in ROUTE_TENSORS[route])
    return index + q * p + q * 2 * 4 * dg.num_segments


def least_s(nbytes: int) -> float:
    return nbytes / HBM_BPS
