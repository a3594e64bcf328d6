"""Depth over the port's copy of the clarity-first spec data model,
reading GFA from stdin (counterpart of examples/spec_depth.py;
reference: mygfa/example.py). It needs no device and imports no torch.

    python examples/torch/spec_depth.py < graph.gfa
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))  # run from a bare checkout

from pollen_tpu_torch.spec.model import Graph  # noqa: E402


def print_depth(graph: Graph) -> None:
    # Count the crossings of every path through every segment.
    seg_depths = {name: 0 for name in graph.segments}
    for path in graph.paths.values():
        for step in path.steps:
            seg_depths[step.name] += 1

    print("seg\tdepth")
    for name, depth in seg_depths.items():
        print(f"{name}\t{depth}")


if __name__ == "__main__":
    print_depth(Graph.parse(sys.stdin))
