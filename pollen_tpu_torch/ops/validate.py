"""Validate: does the link set support every path's adjacent step pairs?
(``validate``, and ``stats``; reference semantics: slow_odgi/validate.py).

A port of pollen_tpu/ops/validate.py. The per-pair hash lookups become a
sorted-set membership test: link endpoint pairs are packed into sorted
keys, and every adjacent step pair in every path is probed with one
batched ``searchsorted`` on the device. A pair (a, b) is supported if
the link a->b exists or the link flip(b)->flip(a) does.

The reference's keys are uint64 ``(from << 32) | to``; torch has no
uint64 search, so the port keeps them as int64 with the sign bit
flipped: ``((from << 32) | to) ^ 2**63`` read as int64, which orders
exactly as the uint64 keys do. It is computed as ``(from - 2**31) *
2**32 + to``, which never overflows int64 for 32-bit handles.
"""

from __future__ import annotations

import numpy as np
import torch

from ..flatgfa import GraphArrays

_HALF = 1 << 31
_SHIFT = 1 << 32


def link_keys(g: GraphArrays) -> np.ndarray:
    """Sorted int64 keys of all links: the uint64 ``(from_handle << 32)
    | to_handle`` with its sign bit flipped."""
    keys = (g.link_from.astype(np.int64) - _HALF) * _SHIFT + g.link_to.astype(
        np.int64
    )
    keys.sort()
    return keys


def _pair_keys(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - _HALF) * _SHIFT + b


def _unsupported_pairs(
    steps: torch.Tensor,  # int64[S] packed handles (natural order)
    step_path: torch.Tensor,  # int[S]
    keys: torch.Tensor,  # int64[L] sorted link keys (link_keys)
) -> torch.Tensor:
    """bool[S-1]: True where (steps[i], steps[i+1]) is an unsupported
    adjacent pair within one path."""
    a = steps[:-1]
    b = steps[1:]
    same_path = step_path[:-1] == step_path[1:]

    def member(k):
        if keys.shape[0] == 0:
            return torch.zeros(k.shape, dtype=torch.bool, device=k.device)
        idx = torch.searchsorted(keys, k).clamp_(0, keys.shape[0] - 1)
        return keys[idx] == k

    fwd = member(_pair_keys(a, b))
    rev = member(_pair_keys(b ^ 1, a ^ 1))
    return same_path & ~(fwd | rev)


def run_validate(g: GraphArrays, device) -> str:
    """The validate report, the pairs probed on ``device``."""
    if g.num_steps < 2:
        return ""
    device = torch.device(device)
    path_ids = g.step_path_ids()
    bad = _unsupported_pairs(
        torch.from_numpy(g.steps.astype(np.int64)).to(device),
        torch.from_numpy(path_ids).to(device),
        torch.from_numpy(link_keys(g)).to(device),
    )
    bad_idx = torch.nonzero(bad).flatten().cpu().numpy()
    if bad_idx.size == 0:
        return ""
    names = g.seg_name.astype("U20")
    segs = g.step_segs
    rev = g.step_reverse.astype(bool)
    lines = []
    for i in bad_idx:
        pname = g.path_name_bytes(int(path_ids[i])).decode()
        a = f"{names[segs[i]]}{'-' if rev[i] else '+'}"
        b = f"{names[segs[i + 1]]}{'-' if rev[i + 1] else '+'}"
        lines.append(
            f"[odgi::validate] error: the path {pname} does not respect "
            f"the graph topology: the link {a},{b} is missing."
        )
    return "\n".join(lines) + "\n"


def run_stats(g: GraphArrays, self_loops: bool = False) -> str:
    """Graph statistics (reference: cli/cmds.rs stats)."""
    if not self_loops:
        return (
            "#length\tnodes\tedges\tpaths\tsteps\n"
            f"{g.seq_data.shape[0]}\t{g.num_segments}\t{g.num_links}\t"
            f"{g.num_paths}\t{g.num_steps}\n"
        )
    from_seg = g.link_from >> 1
    to_seg = g.link_to >> 1
    loops = from_seg == to_seg
    total = int(loops.sum())
    unique = int(np.unique(from_seg[loops]).shape[0])
    return f"#type\tnum\ntotal\t{total}\nunique\t{unique}\n"
