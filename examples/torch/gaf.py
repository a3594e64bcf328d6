"""Iterate a GAF file's reads and their per-segment chunk events on the
PyTorch port (counterpart of examples/gaf.py; reference:
flatgfa-py/examples/gaf.py). The chunk events come from one batched
query on the graph's device, built at the first ``all_reads``.

    python examples/torch/gaf.py [graph.gfa reads.gaf] [--device cuda|cpu]
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(EXAMPLES))  # run from a bare checkout

import pollen_tpu_torch  # noqa: E402


def main(gfa: str, gaf: str, device: str = "cuda") -> None:
    graph = pollen_tpu_torch.parse(gfa, device=device)
    for line in graph.all_reads(gaf):
        print(line.name)
        print(line.sequence())
        print(line.segment_ranges())
        for element in line:
            print(element.handle)
            print(element.range)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("files", nargs="*", metavar="graph.gfa reads.gaf")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args()
    if len(args.files) == 2:
        main(*args.files, args.device)
    else:
        main(os.path.join(EXAMPLES, "example.gfa"),
             os.path.join(EXAMPLES, "example.gaf"), args.device)
