"""The dense query's uniq indicator and a per-tile skip of it, on the
card: the port of the TPU probe ``probes/crossmat_variants.py``.

    v0   the dense query (K2, ``crossmat.masked_cross_depth``)
    v1   exact depth and uniq in the probe ladder's kernel (K11)
    v2   v1, with tiles whose flag is 0 copying depth into uniq; the
         flags mark the tiles holding any count >= 2 (K12)
    v2z  v2 with every flag 0: the floor of the skip (uniq not checked)

Each variant's depth and uniq are checked against v0's (``depth_ok``,
``uniq_ok``) and timed by replaying a CUDA graph of back-to-back calls
(``timing.replay_us``). A tile is one v2 flag's 512 columns. Run on
the card:

    python -m pollen_tpu_torch.probes.crossmat_variants v0 v1 v2 v2z

or on the CPU, host clock, with small POLLEN_BENCH_STEPS / SEGS / PATHS
and ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..kernels import crossmat, crossprobe
from .timing import bench_matrix, result_line, time_call

VARIANTS = ("v0", "v1", "v2", "v2z")


def run(cross: torch.Tensor, mask: torch.Tensor, which=VARIANTS,
        n_steps: int = 2**22) -> dict:
    """Check and time each variant in ``which`` on the nibble matrix
    ``cross`` under the 0/1 ``mask``; prints the complex-tile count and
    one line per variant, and returns {name: {"us", "clock", "depth_ok",
    "uniq_ok"}} plus {"complex_tiles": (flagged, tiles)}."""
    flags = crossprobe.tile_flags(cross, crossprobe.TILE)
    zeros = torch.zeros_like(flags)
    tiles = (int(flags.sum()), flags.numel())
    print(f"# {tiles[0]}/{tiles[1]} complex tiles (width {crossprobe.TILE})",
          flush=True)
    variants = {
        "v0": lambda: crossmat.masked_cross_depth(cross, mask, nibble=True),
        "v1": lambda: crossprobe.cross_probe_v1(cross, mask),
        "v2": lambda: crossprobe.cross_probe_v2(cross, mask, flags),
        "v2z": lambda: crossprobe.cross_probe_v2(cross, mask, zeros),
    }
    ref_d, ref_u = variants["v0"]()
    results = {"complex_tiles": tiles}
    for name in which:
        fn = variants[name]
        d, u = fn()
        ok_d = torch.equal(d, ref_d)
        ok_u = torch.equal(u, ref_u) if name != "v2z" else "skipped"
        us, clock = time_call(fn, cross.device)
        print(result_line(name, us, clock, n_steps,
                          f"depth_ok={ok_d} uniq_ok={ok_u}"), flush=True)
        results[name] = dict(us=us, clock=clock, depth_ok=ok_d, uniq_ok=ok_u)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"any of {', '.join(VARIANTS)}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    which = args.variants or list(VARIANTS)
    bad = [v for v in which if v not in VARIANTS]
    if bad:
        ap.error(f"unknown variants {bad}; choose from {VARIANTS}")
    cross, mask, n_steps = bench_matrix(torch.device(args.device))
    results = run(cross, mask, which, n_steps)
    ok = all(r["depth_ok"] and r["uniq_ok"] in (True, "skipped")
             for k, r in results.items() if k != "complex_tiles")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
