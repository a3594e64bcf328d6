"""Flatten: linearize the graph into FASTA + BED (``flatten``).

A port of pollen_tpu/ops/flatten.py (reference semantics:
slow_odgi/flatten.py; odgi flatten). On the device, an int64 cumsum of
segment lengths gives every segment's place in the linear FASTA space,
and a gather maps each step to its (start, end) interval. The FASTA
text is the segments' sequences glued in id order.

The reference renders one Python line per step; here each path's BED
rows are rendered at once by scattering their digits into one byte
buffer (as the emitter's step tokens are), which gives the same bytes.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

from ..device import TorchGraph
from ..flatgfa import GraphArrays, ragged_gather

FASTA_WIDTH = 80


def step_intervals(dg: TorchGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, end) of each step's segment in linear FASTA space, int64
    on the graph's device."""
    lens = dg.seg_len.long()
    ends = torch.cumsum(lens, 0)
    starts = ends - lens
    step_seg = dg.steps >> 1
    return starts[step_seg], ends[step_seg]


def _digit_counts(v: np.ndarray) -> np.ndarray:
    """Decimal digits of each non-negative int64."""
    nd = np.ones(v.shape, dtype=np.int64)
    top = int(v.max()) if v.size else 0
    limit = 10
    while limit <= top:
        nd += v >= limit
        limit *= 10
    return nd


Field = Union[bytes, np.ndarray]


def render_rows(n: int, fields: List[Field]) -> bytes:
    """``n`` text rows, each the concatenation of ``fields`` and a
    newline. A field is constant ``bytes``, a uint8 array (one
    character a row) or an int64 array (non-negative, in decimal)."""
    widths = []
    for f in fields:
        if isinstance(f, bytes):
            widths.append(np.full(n, len(f), dtype=np.int64))
        elif f.dtype == np.uint8:
            widths.append(np.ones(n, dtype=np.int64))
        else:
            widths.append(_digit_counts(f))
    row_len = sum(widths) + 1
    ends = np.cumsum(row_len)
    buf = np.empty(int(ends[-1]) if n else 0, dtype=np.uint8)
    pos = ends - row_len
    for f, w in zip(fields, widths):
        if isinstance(f, bytes):
            for j, c in enumerate(f):
                buf[pos + j] = c
        elif f.dtype == np.uint8:
            buf[pos] = f
        else:
            last = pos + w - 1
            vals = f.astype(np.int64)
            k = 0
            while True:
                live = w > k
                if not live.any():
                    break
                buf[last[live] - k] = (vals[live] % 10 + 48).astype(np.uint8)
                vals = vals // 10
                k += 1
        pos = pos + w
    buf[pos] = ord("\n")
    return buf.tobytes()


def _fasta_lines(seq: np.ndarray) -> bytes:
    """The sequence wrapped at FASTA_WIDTH columns, each line ending in
    a newline; empty for an empty sequence."""
    n = seq.shape[0]
    full = n // FASTA_WIDTH
    rows = np.empty((full, FASTA_WIDTH + 1), dtype=np.uint8)
    rows[:, :FASTA_WIDTH] = seq[: full * FASTA_WIDTH].reshape(full, FASTA_WIDTH)
    rows[:, FASTA_WIDTH] = ord("\n")
    tail = seq[full * FASTA_WIDTH :].tobytes()
    return rows.tobytes() + (tail + b"\n" if tail else b"")


def run_flatten(g: GraphArrays, dg: TorchGraph, fasta_name: str) -> str:
    starts, ends = (t.cpu().numpy() for t in step_intervals(dg))

    # FASTA: all segment sequences glued in id order, wrapped at 80 cols.
    seq = ragged_gather(
        g.seq_data, g.seg_seq[:, 0].astype(np.int64), g.seg_len.astype(np.int64)
    )
    seq.tobytes().decode("ascii")  # the reference's check: ASCII only
    name = fasta_name.encode()
    parts = [b">" + name + b"\n", _fasta_lines(seq)]
    parts.append(b"#name\tstart\tend\tpath.name\tstrand\tstep.rank\n")
    ori = np.where(
        np.asarray(g.step_reverse).astype(bool), ord("-"), ord("+")
    ).astype(np.uint8)
    for p in range(g.num_paths):
        lo, hi = (int(x) for x in g.path_steps[p])
        if hi <= lo:
            continue
        parts.append(
            render_rows(
                hi - lo,
                [
                    name + b"\t",
                    starts[lo:hi],
                    b"\t",
                    ends[lo:hi],
                    b"\t" + g.path_name_bytes(p) + b"\t",
                    ori[lo:hi],
                    b"\t",
                    np.arange(hi - lo, dtype=np.int64),
                ],
            )
        )
    return b"".join(parts).decode()
