"""Split the dense query's time on the card into its floor and its
unpack: the port of the TPU probe ``probes/crossmat_floor.py``.

    raw  one load and one multiply-add per byte, no unpack (K10 raw)
    vd   nibble unpack and the exact depth, no indicator (K10 vd)
    v0   the dense query itself (K2, ``crossmat.masked_cross_depth``)

Each variant is checked against its plain version on the same device
(``exact=``) and timed by replaying a CUDA graph of back-to-back calls
(``timing.replay_us``). Run on the card:

    python -m pollen_tpu_torch.probes.crossmat_floor raw vd v0

or on the CPU, host clock, with small POLLEN_BENCH_STEPS / SEGS / PATHS
and ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..kernels import crossmat, crossprobe
from .timing import bench_matrix, result_line, time_call

VARIANTS = ("raw", "vd", "v0")


def run(cross: torch.Tensor, mask: torch.Tensor, which=VARIANTS,
        n_steps: int = 2**22) -> dict:
    """Check and time each variant in ``which`` on the nibble matrix
    ``cross`` under the 0/1 ``mask``; prints one line each and returns
    {name: {"us", "clock", "exact"}}."""
    variants = {
        "raw": (lambda: crossprobe.cross_probe_raw(cross, mask),
                lambda: crossprobe.cross_probe_plain(cross, mask, "raw")),
        "vd": (lambda: crossprobe.cross_probe_vd(cross, mask),
               lambda: crossprobe.cross_probe_plain(cross, mask, "vd")),
        "v0": (lambda: crossmat.masked_cross_depth(cross, mask, nibble=True),
               lambda: crossprobe.cross_probe_plain(cross, mask, "v1")),
    }
    results = {}
    for name in which:
        kernel, plain = variants[name]
        exact = all(torch.equal(a, b) for a, b in zip(kernel(), plain()))
        us, clock = time_call(kernel, cross.device)
        print(result_line(name, us, clock, n_steps, f"exact={exact}"),
              flush=True)
        results[name] = dict(us=us, clock=clock, exact=exact)
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
    return 0 if all(r["exact"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
