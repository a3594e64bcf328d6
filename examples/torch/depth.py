"""Node depth two ways on the PyTorch port: a pure-Python walk over the
object API, and the same count as one vectorized query on the device,
and a check that they agree (counterpart of examples/depth.py;
reference analogue: flatgfa-py/examples/depth.py, which only does the
Python walk).

    python examples/torch/depth.py [graph.gfa] [--device cuda|cpu]
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(EXAMPLES))  # run from a bare checkout

import pollen_tpu_torch  # noqa: E402


def depth_by_walking(graph) -> dict:
    """Object-API style: every step crosses the facade one at a time."""
    depths = dict.fromkeys((s.id for s in graph.segments), 0)
    for path in graph.paths:
        for step in path:
            depths[step.seg_id] += 1
    return depths


def main(path: str, device: str = "cuda") -> None:
    graph = pollen_tpu_torch.parse(path, device=device)
    walked = depth_by_walking(graph)

    # The same query as one vectorized histogram over the flat arrays,
    # on the device the caller named (a CUDA device with no card raises).
    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.ops.depth import seg_depth_with_uniq

    vectorized, _uniq = seg_depth_with_uniq(build_graph(graph.arrays, device))
    vectorized = vectorized.cpu().tolist()
    assert all(vectorized[i] == d for i, d in walked.items())

    print("#node.id\tdepth")
    for seg in graph.segments:
        print(f"{seg.name}\t{walked[seg.id]}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("gfa", nargs="?",
                        default=os.path.join(EXAMPLES, "example.gfa"))
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args()
    main(args.gfa, args.device)
