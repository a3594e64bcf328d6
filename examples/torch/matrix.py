"""Pangenotype matrix for a graph plus a directory of GAF files, on the
PyTorch port (counterpart of examples/matrix.py; reference:
flatgfa-py/examples/matrix.py). The matrix is built on the host, as the
JAX package builds it; ``--device`` is checked as every example checks
it (a CUDA device with no card raises).

    python examples/torch/matrix.py [graph.gfa gaf_dir] [--device cuda|cpu]
"""

import argparse
import pathlib
import sys
from itertools import islice

EXAMPLES = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(EXAMPLES.parent))  # run from a bare checkout

import pollen_tpu_torch  # noqa: E402
from pollen_tpu_torch.device import resolve_device  # noqa: E402

FIRST_N = 100


def matrix_demo(gfa_path: str, gaf_dir: str, device: str = "cuda") -> None:
    graph = pollen_tpu_torch.parse(gfa_path, device=resolve_device(device))
    gaf = sorted(str(p) for p in pathlib.Path(gaf_dir).glob("*.gaf"))
    pangenotype_matrix = graph.make_pangenotype_matrix(gaf)

    assert len(pangenotype_matrix) == len(gaf)

    for gaf_path, row in zip(gaf, pangenotype_matrix):
        first_bits = islice(row, FIRST_N)
        print(pathlib.Path(gaf_path).name, *map(int, first_bits))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("files", nargs="*", metavar="graph.gfa gaf_dir")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args()
    if len(args.files) != 2:
        matrix_demo(str(EXAMPLES / "example.gfa"), str(EXAMPLES), args.device)
    else:
        matrix_demo(*args.files, args.device)
