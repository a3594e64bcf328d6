"""The fixed-dimension depth "processing element" array in plain torch.

A port of pollen_tpu/accel/kernel.py (reference semantics:
pollen_py/pollen/depth/calyx_depth.py): every node owns a fixed memory
of crossing path ids; its PE counts considered crossings (depth) and
popcounts the AND of its paths-on-node bitvector with the
paths-to-consider bitvector (unique depth). All PEs run at once: the
node axis is the batch, and the paths-on-node bitvectors are one
(N, P+1) bool presence matrix scattered on the device (the reference
forms it as an N x E x (P+1) compare; the result is the same).

JAX clamps an out-of-range gather index where torch raises, so the
lookup of a path id in ``consider`` clamps explicitly (a negative id
wraps once, then every id is clamped into [0, P]), and ids outside
[0, P] mark no path present, as in the reference's compare.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import op_tensor


def _clamped(ids: torch.Tensor, size: int) -> torch.Tensor:
    """JAX's gather index rule for ``x[ids]`` with ``len(x) == size``."""
    return torch.where(ids < 0, ids + size, ids).clamp(0, size - 1)


def _inputs(path_ids, consider) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both memories as tensors on the device of ``path_ids`` (the CPU
    when it is a host array): each argument a tensor on that device or,
    as the reference takes them, a numpy array, converted once (int32);
    ``consider`` is an int32 copy with slot 0 cleared."""
    dev = path_ids.device if isinstance(path_ids, torch.Tensor) else "cpu"
    path_ids = op_tensor(path_ids, dev, torch.int32)
    consider = op_tensor(consider, dev, torch.int32)
    consider = consider.to(torch.int32).clone()
    consider[:1].zero_()  # a fill: no host copy, so graph-capturable
    return path_ids, consider


def node_depth_accel(
    path_ids: torch.Tensor,  # int32[N, E], 0 = empty slot
    consider: torch.Tensor,  # int32[P+1] bitvector (index 0 unused)
    max_p: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth int32[N], uniq int32[N]) for all node PEs at once."""
    path_ids, consider = _inputs(path_ids, consider)
    ids = path_ids.long()

    # depth: count considered crossings (slot 0 never counts).
    depth = consider[_clamped(ids, max_p + 1)].sum(1, dtype=torch.int32)

    # uniq: presence bitvector per node AND consider, popcounted. Ids no
    # PE port matches land in a spare last column.
    col = torch.where((ids >= 0) & (ids <= max_p), ids, max_p + 1)
    presence = torch.zeros(
        (ids.shape[0], max_p + 2), dtype=torch.bool, device=ids.device
    )
    presence.scatter_(1, col, torch.ones_like(col, dtype=torch.bool))
    presence = presence[:, : max_p + 1] & (consider > 0)
    uniq = presence.sum(1, dtype=torch.int32)
    return depth, uniq


def run_accel(path_ids: np.ndarray, consider: np.ndarray, device):
    """Marshal memories in, run the PE array on ``device``,
    marshal out."""
    max_p = consider.shape[0] - 1
    depth, uniq = node_depth_accel(
        torch.from_numpy(np.asarray(path_ids)).to(device),
        torch.from_numpy(np.asarray(consider)).to(device),
        max_p,
    )
    return depth.cpu().numpy(), uniq.cpu().numpy()


def node_depth_accel_simple(
    path_ids: torch.Tensor,  # int32[N, E], 0 = empty slot
    consider: torch.Tensor,  # int32[P+1] bitvector (index 0 unused)
    max_p: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-PE variant: one processing element re-used across nodes.

    Reference semantics: pollen_py/pollen/depth/processing-elements/
    calyx_depth_simple.py — the design-study generator that time-shares
    one hardware PE over every node instead of instantiating one per
    node. The node axis is a sequential loop carrying the PE through the
    node memories, each PE step the reference's compare; outputs equal
    the batched PE array's."""
    path_ids, consider = _inputs(path_ids, consider)
    ids = torch.arange(max_p + 1, device=path_ids.device)
    n = path_ids.shape[0]
    depth = torch.zeros(n, dtype=torch.int32, device=path_ids.device)
    uniq = torch.zeros(n, dtype=torch.int32, device=path_ids.device)
    for i in range(n):
        node_ids = path_ids[i].long()
        depth[i] = consider[_clamped(node_ids, max_p + 1)].sum()
        presence = (node_ids[:, None] == ids).any(0) & (consider > 0)
        uniq[i] = presence.sum()
    return depth, uniq
