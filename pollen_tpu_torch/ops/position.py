"""Position lookup: bp offset along a path -> (segment, in-segment offset)
(``position``).

A port of pollen_tpu/ops/position.py (reference semantics:
flatgfa/src/ops/position.rs, a linear walk). The walk becomes an int64
prefix sum of step lengths plus a ``searchsorted`` on the device, and
the lookup is batched: many offsets of one path in one call.

JAX clamps an out-of-range gather index where torch raises, so every
index the reference clamps implicitly is clamped here explicitly (into
[0, S - 1]); the answers, the invalid rows' included, are the
reference's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import TorchGraph, op_tensor
from ..flatgfa import GraphArrays


def positions_in_path(
    dg: TorchGraph, path_id: int, offsets
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each query offset along one path, the step's packed handle,
    the offset within that segment, and a validity flag. ``offsets`` is
    a tensor or a numpy array, as the reference takes it; it is taken to
    the graph's device as int64 once, here.

    Returns (handles int64[Q], seg_offsets int64[Q], valid bool[Q]).
    """
    s = dg.num_steps
    offsets = op_tensor(offsets, dg.device, torch.int64, move=True)
    if s == 0:
        zeros = torch.zeros_like(offsets)
        return zeros, offsets.clone(), offsets < 0
    # [lo, hi] as a tensor, read on the device: no host round trip, so
    # the lookup can be captured in a CUDA graph.
    lo_hi = dg.path_bounds[path_id : path_id + 2].long()
    lo, hi = lo_hi[0], lo_hi[1]
    pos = torch.arange(s, device=dg.device)
    in_path = (pos >= lo) & (pos < hi)
    step_seg = dg.steps >> 1
    lens = torch.where(in_path, dg.seg_len[step_seg].long(), 0)
    # Cumulative bp along this path, over the global step array, with a
    # leading 0: ends0[i] is the reference's ends[i - 1], ends0[0] its 0
    # for lo == 0 or hi == 0.
    ends0 = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    base, end = ends0[lo_hi]
    rel_ends = ends0[1:] - base  # bp end of each step relative to path start

    total = end - base
    valid = offsets < total

    # First step whose relative end exceeds the offset.
    idx = torch.searchsorted(rel_ends, offsets, right=True)
    idx = torch.minimum(torch.maximum(idx, lo), torch.maximum(hi - 1, lo))
    idx = idx.clamp(max=s - 1)
    starts = rel_ends[idx] - lens[idx]
    return dg.steps[idx], offsets - starts, valid


def run_position(
    g: GraphArrays, dg: TorchGraph, path_name: str, offset: int
) -> Optional[str]:
    """CLI-style single lookup (reference: cli/cmds.rs position)."""
    pid = g.path_id_by_name(path_name.encode())
    if pid is None:
        raise KeyError(f"path not found: {path_name}")
    handles, seg_offs, valid = positions_in_path(
        dg, pid, torch.tensor([offset], dtype=torch.int64)
    )
    if not bool(valid[0]):
        return None
    handle = int(handles[0])
    seg_off = int(seg_offs[0])
    name = int(g.seg_name[handle >> 1])
    ori = "-" if handle & 1 else "+"
    return (
        "#source.path.pos\ttarget.graph.pos\n"
        f"{path_name},{offset},+\t{name},{seg_off},{ori}\n"
    )
