"""Batched subset-depth serving with the PyTorch port: one resident
graph, many path-subset queries answered in a single device pass
(counterpart of examples/batch_depth.py; the reference answers one
query per fgfa invocation, and no equivalent exists there).

    python examples/torch/batch_depth.py [graph.gfa] [--device cuda|cpu]

The masks are numpy bool arrays, as in the JAX package's example: the
port's queries take numpy masks or tensors alike.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(EXAMPLES))  # run from a bare checkout


def main(path: str, device: str = "cuda") -> None:
    import numpy as np

    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.flatgfa import parse_gfa_file
    from pollen_tpu_torch.ops.depth import (
        path_mask_for,
        seg_depth_with_uniq_batch,
    )

    g = parse_gfa_file(path)
    # ell_objective="batch" plans the resident index for batched
    # throughput. On an NVIDIA H100 80GB HBM3 at a 700 W power limit
    # (chip_smoke.py, CUDA-event wall per call, the bench graph): the
    # device part of a Q = 32 batch 249.30 us (7.79 us/query); this whole
    # call 8.68-15.83 ms at Q = 3 and 143.27 ms at Q = 32, nearly all of
    # it composing the (Q, N) answer in segment order on the host.
    dg = build_graph(g, device, ell_objective="batch")

    names = [g.path_name_bytes(i).decode() for i in range(g.num_paths)]
    subsets = [names[:1], names, names[::2]]
    masks = np.stack([path_mask_for(g, s) for s in subsets])

    depth, uniq = seg_depth_with_uniq_batch(dg, masks)
    for q, subset in enumerate(subsets):
        print(f"# subset {q}: {','.join(subset)}")
        print("#node.id\tdepth\tdepth.uniq")
        for i in range(g.num_segments):
            print(f"{g.seg_name[i]}\t{depth[q][i]}\t{uniq[q][i]}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("gfa", nargs="?",
                        default=os.path.join(EXAMPLES, "example.gfa"))
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args()
    main(args.gfa, args.device)
