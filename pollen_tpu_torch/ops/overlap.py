"""Path overlap: which paths share an oriented step with a query path
(``overlap``; reference semantics: slow_odgi/overlap.py).

A port of pollen_tpu/ops/overlap.py. The pairwise set intersection
becomes a path × handle incidence matrix multiplied with its own
transpose: one bf16 matrix product answers every path pair at once.
The incidence is built on the graph's device by a scatter from the
steps (the reference builds it on the host: 805 MB at 96 paths and
2^22 segments).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..device import TorchGraph
from ..flatgfa import GraphArrays
from .depth import path_depth


def _incidence(g: GraphArrays, dg: TorchGraph) -> torch.Tensor:
    """bool[P, 2N] on the graph's device — does path p use handle h
    (segment + orientation)?"""
    inc = torch.zeros(
        (dg.num_paths, 2 * dg.num_segments), dtype=torch.bool, device=dg.device
    )
    path_ids = torch.from_numpy(g.step_path_ids()).to(dg.device).long()
    inc[path_ids, dg.steps] = True
    return inc


def _touch_matrix(inc: torch.Tensor) -> torch.Tensor:
    """bool[P, P]: do two (distinct) paths share any handle?

    The entries are 0/1, so every product term is >= 0 and a shared
    count is > 0 exactly when one term is 1: the ``> 0`` test is exact
    whatever the precision of the bf16 product and its rounding."""
    m = inc.to(torch.bfloat16)
    touches = torch.matmul(m, m.T) > 0
    eye = torch.eye(inc.shape[0], dtype=torch.bool, device=inc.device)
    return touches & ~eye


def run_overlap(
    g: GraphArrays, dg: TorchGraph, query_paths: List[str]
) -> str:
    by_name = {g.path_name_bytes(i).decode(): i for i in range(g.num_paths)}
    for q in query_paths:
        if q not in by_name:
            raise KeyError(f"no such path: {q}")

    touches = _touch_matrix(_incidence(g, dg)).cpu().numpy()
    lengths = path_depth(dg)[0].cpu().numpy()

    lines = []
    for q in query_paths:
        qi = by_name[q]
        for other in np.flatnonzero(touches[qi]):
            lines.append(
                f"{q}\t0\t{int(lengths[qi])}\t"
                f"{g.path_name_bytes(int(other)).decode()}"
            )
    if not lines:
        return ""
    return "\n".join(["#path\tstart\tend\tpath.touched"] + lines) + "\n"
