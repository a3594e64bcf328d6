"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place with one guarantee broken (each
path's count on a segment held in a 4-bit nibble, the overflow dropped;
``reference.CONTROL_CLIP``). It goes through a whole run of the cell
(``harness.run_cell`` with the control as its ``fault``), so the same
window, sample, check and result line judge it as they judge the
program. The benchmark's runs do not run it.

    python -m portbench.control --workload <cell> --seconds 3 --seeds 1 2 3

For each seed it prints one JSON line: the seed, ``correct`` and the
numbers compared beside their limits.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import harness, reference


def control(entry, g):
    """An entry that answers with the control, from the arena ``g``."""
    ref = reference.Reference(g.steps, g.path_steps, g.num_segments)

    def call(dg, masks):
        m = np.asarray(masks, bool)
        depth, uniq = ref.answers(m, clip=reference.CONTROL_CLIP)
        depth, uniq = depth.astype(np.int32), uniq.astype(np.int32)
        return (depth[0], uniq[0]) if m.ndim == 1 else (depth, uniq)
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        run, out = harness.run_cell(args.workload, seed, args.seconds, False,
                                    "cuda", fault=control)
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "correct": out["correct"], "calls": run.calls,
                          "answers": run.answers_checked,
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
