"""Degree query: incident link endpoints per segment (``degree``).

A port of pollen_tpu/ops/degree.py. Semantics follow the spec
(reference: slow_odgi/degree.py): each link contributes one
out-endpoint and one in-endpoint, and a segment's degree counts both of
its orientations — so degree[s] = #(from-endpoints on s) +
#(to-endpoints on s). On the device this is a boundary difference over
the endpoint histogram built at ingest (``link_seg_bounds``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import TorchGraph
from ..flatgfa import GraphArrays


def seg_degree(dg: TorchGraph) -> torch.Tensor:
    """Degree per segment: int32[N] on the graph's device."""
    return dg.link_seg_bounds[1:] - dg.link_seg_bounds[:-1]


def degree_table(g: GraphArrays, degrees: np.ndarray) -> str:
    names = g.seg_name.astype("U20")
    body = [f"{n}\t{d}" for n, d in zip(names, np.asarray(degrees))]
    return "\n".join(["#node.id\tnode.degree"] + body) + "\n"


def run_degree(g: GraphArrays, dg: TorchGraph) -> str:
    return degree_table(g, seg_degree(dg).cpu().numpy())
