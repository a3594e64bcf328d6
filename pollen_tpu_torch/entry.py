"""The flagship forward step on a tiny graph.

The port of the JAX package's entry point (``__graft_entry__.py``
``entry``): the masked segment-depth plus unique-depth query over the
(segment, path)-sorted step index (see :mod:`pollen_tpu_torch.device`
and :mod:`pollen_tpu_torch.ops.depth`), on a four-segment, two-path
graph whose answers are checked by hand: depth ``[2, 3, 1, 1]``, unique
depth ``[2, 2, 1, 1]`` under the all-paths mask.
"""

from __future__ import annotations

from .flatgfa import GraphArrays, parse_gfa

TINY_GFA = (
    "H\tVN:Z:1.0\n"
    "S\t1\tACGT\nS\t2\tTT\nS\t3\tGATTACA\nS\t4\tC\n"
    "P\talpha\t1+,2+,3+,2-\t*\nP\tbeta\t1+,2+,4+\t*\n"
    "L\t1\t+\t2\t+\t0M\nL\t2\t+\t3\t+\t0M\nL\t2\t+\t4\t+\t0M\n"
)


def tiny_arena() -> GraphArrays:
    return parse_gfa(TINY_GFA.encode())


def entry(device="cuda"):
    """(forward, example_args) for the flagship forward step, its index
    built on ``device`` (default cuda; without a card that is an
    error)."""
    import torch

    from .device import build_graph
    from .ops.depth import seg_depth_with_uniq_masked

    dg = build_graph(tiny_arena(), device)
    mask = torch.ones(dg.num_paths, dtype=torch.bool, device=dg.device)

    def forward(dg, mask):
        return seg_depth_with_uniq_masked(dg, mask)

    return forward, (dg, mask)
