"""Time the GAF chunker's ways of finding each read's base offset, on
the card, at the chr8_third read set of ``chip_smoke.py``.

    shipped  ``ops.gaf.chunk_reads``: each read's first step index
             scattered to its read and gathered back (``_read_base``)
    cummax   the same with the reference's form of that step: a running
             max over read-start markers (``jax.lax.associative_scan``),
             as ``torch.cummax``

Both are checked equal on the same inputs, then timed by replaying a
CUDA graph of back-to-back calls (``timing.replay_us``). Run on the
card:

    python -m pollen_tpu_torch.probes.gaf_chunker shipped cummax

or on the CPU, host clock, at a small size:

    POLLEN_GAF_STEPS=65536 POLLEN_GAF_SEGS=4096 POLLEN_GAF_READS=4096 \\
      python -m pollen_tpu_torch.probes.gaf_chunker --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..ops import gaf
from ..synth import synth_gaf, synth_graph
from .timing import time_call

VARIANTS = ("shipped", "cummax")


def read_base_cummax(pos_global, read_id, n_reads: int):
    """``ops.gaf._read_base`` as the reference computes it: a running max
    over read-start markers (pos_global never decreases)."""
    is_first = torch.ones_like(read_id, dtype=torch.bool)
    is_first[1:] = read_id[1:] != read_id[:-1]
    return torch.cummax(torch.where(is_first, pos_global, -1), 0).values


def with_base(read_base):
    """``chunk_reads`` with ``read_base`` in place of the shipped one."""

    def call(*inputs):
        shipped = gaf._read_base
        gaf._read_base = read_base
        try:
            return gaf.chunk_reads(*inputs)
        finally:
            gaf._read_base = shipped

    return call


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gaf_chunker")
    parser.add_argument("variants", nargs="*", default=list(VARIANTS))
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    steps = int(os.environ.get("POLLEN_GAF_STEPS", 2**25))
    segs = int(os.environ.get("POLLEN_GAF_SEGS", 2**22))
    reads = int(os.environ.get("POLLEN_GAF_READS", 2**20))
    g = synth_graph(steps, segs, 96)
    r = gaf.parse_gaf(synth_gaf(g, reads, seed=17, max_steps=31),
                      g.seg_id_by_name())
    read_id = np.repeat(np.arange(r.num_reads, dtype=np.int32),
                        np.diff(r.read_bounds))
    inputs = (
        torch.from_numpy(g.seg_len.astype(np.int32)).to(device),
        torch.from_numpy(r.steps.view(np.int32)).to(device),
        torch.from_numpy(read_id).to(device),
        torch.from_numpy(r.start).to(device),
        torch.from_numpy(r.end).to(device),
    )
    fns = {"shipped": gaf.chunk_reads,
           "cummax": with_base(read_base_cummax)}
    want = gaf.chunk_reads(*inputs)
    t = r.steps.shape[0]
    for name in args.variants:
        got = fns[name](*inputs)
        exact = all(torch.equal(x, y) for x, y in zip(got, want))
        us, how = time_call(lambda: fns[name](*inputs), device)
        print(f"{name}: {us:.2f} us/call ({how}) at T={t} read steps, "
              f"R={r.num_reads} reads, N={segs}; exact={exact}", flush=True)
        if not exact:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
