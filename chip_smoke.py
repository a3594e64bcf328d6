#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with one CUDA card,
``nvcc`` and PyTorch (no JAX needed). It builds the port's CUDA kernels
from ``pollen_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel)
and then:

1. holds every kernel against its plain PyTorch version on the card,
   on all fixture graphs, exact: fused split ELL K1, crossing matrix K2
   in both layouts and depth-only, tall tier K3 with pack16 and 32-bit
   slots (4 seeded masks each); the batched split ELL K4 on 1-3 tiers,
   with and without a heavy block, and the batched crossing matrix K5
   in both layouts, at Q = 1, 5, 32 and 40 seeded masks; K5 also with
   every cell at its clip under all-ones masks, at P = 2 to 300 paths,
   Q = 1, 5, 16, 17, 32, 40, and on a matrix 4 bytes off a 16-byte
   boundary (and at full size on bench's matrix under a seeded Q = 32
   batch, before its timing); K2 too at the clip, on byte rows 1, 13,
   33, 100 and 2,500 by 128 to 4,736 columns, masks shorter and longer
   than the paths, int8 over -128..127 and a matrix 4 bytes off 16, each
   with and without uniq (and at full size on chr8_third's 256 MiB
   matrix under a seeded and the all-ones mask, before its timing); K1
   and K4 on random tiers at P = 1 to 40,000 paths (K4's packing launch
   past 4,096), the heavy block alone, 1-3 tiers (one of 9 words), tiers
   alone, Q = 1 to 65, the heavy clip, a heavy block 4 bytes off 16, 20
   back-to-back calls and CUDA-graph replays; and cuobjdump's SASS of
   K4 and K5 must hold int8 tensor-core instructions (IMMA);
2. drives the main paths through the user's entry points: ``fgfa-torch
   --device cuda depth -d``, ``depth -d -s`` and ``depth -d -S`` on
   every fixture, byte for byte against the goldens, and a ``serve``
   loop of four requests (one ``-S``);
3. ingests synthetic graphs at bench and chromosome scale, sends 8
   masks each through the routed ``depth -d -s`` query and a batch of
   32 through the routed batch query (also under a batch plan and on
   bench's crossing matrix), and checks each answer against the plain
   PyTorch path on the card and an independent numpy reference; then
   times one query, the batch at Q = 1, 8, 16, 32, and each kernel,
   kernel against plain.

The scan family (graphs past the ELL and crossing-matrix budgets) is
checked the same way: segment scan K6, boundary gather K7 and run scan
K8 against their plain versions on the fixtures and on seeded cases of
1-3 scan blocks at 60 to 2^17 + 300 paths, a group across three blocks
and a head carry, and K6's single pass at 2^25 steps (one group; a
group start every 7 steps; 20 back-to-back calls; two replays of a
captured CUDA graph), and K8's at 2^25 runs (all-ones mask, the
weighted sum wrapping past 2^31; seeded runs; 20 back-to-back calls;
two graph replays) (phase 1); ``depth -d -s`` (route "scan") and
``depth -d -S`` (route "runs") goldens and a ``serve`` request of each
under POLLEN_CROSS_BUDGET_MB=0 (phase 2); and two synthetic graphs,
wide_p2e17 (2^17 paths, route "scan") and bench_runs (route "runs"),
8 masks and a Q = 32 batch each, against plain and numpy (phase 3).

The flat single-tier ELL (K9) and the crossing-matrix probe ladder
(K10 raw and vd, K11, K12) are checked against their plain versions on
the fixtures, on path ids up to 65535 and on a seeded matrix where only
some tiles hold counts >= 2 (phase 1). Two more paths follow: the flat
ELL path (``build_ell`` on the real runs of bench and chr8_third, then
``masked_ell_depth`` under 8 masks, against plain, numpy and the routed
query) and the probe path (the two probe scripts' ``run`` on bench's
16 MiB crossing matrix and chr8_third's 256 MiB one). K9 is timed
against K3 on the same slots (flat against tall).

Launch counts are set to 0 right before each main path (the single
query: phase 2's single-query requests and phase 3's queries; the
batch: phase 2's ``-S`` requests and phase 3's batches; the scan
family: its phase 2 requests and phase 3 queries and batches; the flat
ELL path; the probe path) and read right after it: every kernel must
have been launched by its path. Each kernel's time is its CUDA-event
wall per call and its device time per call from a replayed CUDA graph
(``pollen_tpu_torch/probes/timing.py``), beside its plain version's
wall, its bound and its library call (wall and replay): one PyTorch
call of the same function (K2, K5: a product by [A | min(A, 1)]; K6,
K8: two cumsums; K1, K3, K4, K9: one torch.sparse.mm of CSR counts by
the masks, ``probes/yardstick.py``), where there is one. K2 and K8 have
a second row at HBM scale (chr8_third's crossing matrix; wide_p2e17's
run index), K1 and K4 one at chr8_third's index, and the profiler must
show K6 and K8 each as one single-pass scan launch, K1 and K4 each as
their one kernel (no packing launch ahead).
Exits nonzero
at the first failed check. The line before the last is one JSON object
with each kernel's launches, error, times, bound and library call
times; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import io
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
SRC = "pollen_tpu_torch/csrc/depth.cu"
SRC_BATCH = "pollen_tpu_torch/csrc/depth_batch.cu"
SRC_SCAN = "pollen_tpu_torch/csrc/scan.cu"
SRC_PROBES = "pollen_tpu_torch/csrc/probes.cu"
# name -> (source, TPU kernel replaced, launch-count key)
KERNELS = {
    "ell_splitn (K1)": (SRC, "pollen_tpu/kernels/ellscan.py:539", "ell_splitn"),
    "cross (K2)": (SRC, "pollen_tpu/kernels/crossmat.py:102", "cross"),
    "ell_tier (K3)": (SRC, "pollen_tpu/kernels/ellscan.py:474", "ell_tier"),
    "ell_splitn_batch (K4)": (
        SRC_BATCH, "pollen_tpu/kernels/ellscan.py:882", "ell_splitn_batch"
    ),
    "cross_batch (K5)": (
        SRC_BATCH, "pollen_tpu/kernels/crossmat.py:290", "cross_batch"
    ),
    "seg_scan (K6)": (SRC_SCAN, "pollen_tpu/kernels/segscan.py:129", "seg_scan"),
    "boundary (K7)": (SRC_SCAN, "pollen_tpu/kernels/gatherb.py:123", "boundary"),
    "run_scan (K8)": (SRC_SCAN, "pollen_tpu/kernels/runscan.py:65", "run_scan"),
    # K2 and K8 timed a second time at HBM scale (the same kernels; their
    # launches are their main paths' counts).
    "cross (K2), chr8_third matrix": (
        SRC, "pollen_tpu/kernels/crossmat.py:102", "cross"
    ),
    "run_scan (K8), wide_p2e17": (
        SRC_SCAN, "pollen_tpu/kernels/runscan.py:65", "run_scan"
    ),
    # K1 and K4 timed a second time at chr8_third's index (three tiers).
    "ell_splitn (K1), chr8_third": (
        SRC, "pollen_tpu/kernels/ellscan.py:539", "ell_splitn"
    ),
    "ell_splitn_batch (K4), chr8_third": (
        SRC_BATCH, "pollen_tpu/kernels/ellscan.py:882", "ell_splitn_batch"
    ),
    "ell_flat (K9)": (SRC, "pollen_tpu/kernels/ellscan.py:326", "ell_flat"),
    "cross_probe_raw (K10)": (
        SRC_PROBES, "probes/crossmat_floor.py:49", "cross_probe_raw"
    ),
    "cross_probe_vd (K10)": (
        SRC_PROBES, "probes/crossmat_floor.py:58", "cross_probe_vd"
    ),
    "cross_probe_v1 (K11)": (
        SRC_PROBES, "probes/crossmat_variants.py:49", "cross_probe_v1"
    ),
    "cross_probe_v2 (K12)": (
        SRC_PROBES, "probes/crossmat_variants.py:64", "cross_probe_v2"
    ),
}
# The kernels of each main path: the single query, the batch, the scan
# family (single queries and batches past the ELL and matrix budgets).
SINGLE_PATH = ("ell_splitn (K1)", "cross (K2)", "ell_tier (K3)",
               "cross (K2), chr8_third matrix", "ell_splitn (K1), chr8_third")
BATCH_PATH = ("ell_splitn_batch (K4)", "cross_batch (K5)",
              "ell_splitn_batch (K4), chr8_third")
SCAN_PATH = ("seg_scan (K6)", "boundary (K7)", "run_scan (K8)",
             "run_scan (K8), wide_p2e17")
# The flat-ELL path (build_ell, then masked_ell_depth) and the probe
# ladder (the two probe scripts' run()).
FLAT_PATH = ("ell_flat (K9)",)
PROBE_PATH = ("cross_probe_raw (K10)", "cross_probe_vd (K10)",
              "cross_probe_v1 (K11)", "cross_probe_v2 (K12)")
# Batch sizes of phase 1 (40: over the kernels' 32-query chunk) and of
# the batch timing.
KERNEL_QS = (1, 5, 32, 40)
TIMING_QS = (1, 8, 16, 32)
# K5's edge batches: 16 fills one tensor-core row tile, 17 spills over.
CROSS_QS = (1, 5, 16, 17, 32, 40)
# Synthetic graphs of phase 3: (steps, segments, paths), seed 8.
SCALE = {
    "bench": (2**22, 2**18, 128),
    "bench_p300": (2**22, 2**18, 300),
    "chr8_third": (2**25, 2**22, 96),
    # An "ell" graph whose heavy block is below SEG_BLOCK: the unfused
    # route, where the main path runs K3 and K2 instead of K1.
    "unfused": (2**20, 2**17, 128),
}
# Scan-family graphs of phase 3: (steps, segments, paths), ingest
# options, the route the single-query router must pick.
SCAN_SCALE = {
    "wide_p2e17": ((2**25, 2**22, 2**17), {}, "scan"),
    "bench_runs": ((2**22, 2**18, 128), {"cross_matrix": "never"}, "runs"),
}
# Phase 1 scan cases: paths (60, 200: few mask words; 2040, 2300: the
# reference's select and one-hot regimes; 2^17: the most words staged
# in shared memory; 2^17 + 300: words read from global memory).
SCAN_PS = (60, 200, 2040, 2300, 2**17, 2**17 + 300)
SCAN_BLOCK = 128 * 128  # the reference's scan block, the indexes' padding
L2_BYTES = 50 * 2**20
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; int8 tensor
# core ops/s (the dense mask products: 0/1 masks and counts <= 127 are
# exact in int8); float32 ops/s outside the tensor cores, taken as the
# CUDA cores' rate for the integer work of slot decoding and scans.
HBM_BPS = 3.35e12
INT8_TENSOR_OPS = 1979e12
CUDA_CORE_OPS = 67e12


class SmokeError(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout
    return out.strip().splitlines()[0]


def check_sass(lib: pathlib.Path):
    """The int8 tensor-core products are in the built code: cuobjdump's
    SASS of every instance of K4's kernel and of K5's holds IMMA."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    found = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        for kernel in ("ell_splitn_batch_kernel", "cross_mma_kernel"):
            if kernel in name:
                found.setdefault(kernel, []).append(fn.count("IMMA"))
    print(f"cuobjdump -sass: IMMA instructions per instance {found}",
          flush=True)
    need(len(found) == 2 and all(min(n) > 0 for n in found.values()),
         f"K4 or K5 built without int8 tensor-core products: {found}")


def cuda_ms(fn, reps=30, warm=5):
    """Median device time of one call, CUDA events around each call;
    5 calls where one takes over 50 ms (the plain segment scan at
    wide_p2e17)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 0.05:
        reps = min(reps, 5)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(fn, reps=30):
    """Device time per call by kernel name (torch.profiler, CUPTI), as
    {name: us}; empty when the trace holds no device events. Only device
    activity is traced: host events of plain calls (thousands of small
    operations) would make the trace slow to read back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for evt in prof.events():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            name = evt.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].replace("void ", "")
            per[name] = per.get(name, 0.0) + evt.time_range.elapsed_us() / reps
    return per


def describe_profile(per: dict) -> str:
    if not per:
        return "device time not measured (no device events in the trace)"
    busy = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    return f"device busy {busy:.2f} us/call: " + ", ".join(
        f"{n} {us:.2f}" for n, us in top
    )


def _counters():
    from pollen_tpu_torch.kernels import (
        crossmat, crossprobe, ellscan, gatherb, runscan, segscan,
    )

    return [m.launches for m in (ellscan, crossmat, segscan, gatherb, runscan,
                                 crossprobe)]


def reset_launches():
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict:
    out = {}
    for counts in _counters():
        out.update(counts)
    return out


def bound(nbytes, core_ops=0, tensor_ops=0):
    """(least ms, what bounds it): the bytes over HBM_BPS against the
    operations over their peaks."""
    by_bytes = nbytes / HBM_BPS * 1e3
    by_ops = (core_ops / CUDA_CORE_OPS + tensor_ops / INT8_TENSOR_OPS) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


class Errors:
    """Largest |kernel - plain| seen per kernel."""

    def __init__(self):
        self.max = {name: None for name in KERNELS}

    def compare(self, name, got, want, what):
        import torch

        need(len(got) == len(want), f"{name} {what}: {len(got)} outputs, "
             f"plain gives {len(want)}")
        for g, w in zip(got, want):
            need((g is None) == (w is None), f"{name} {what}: class present "
                 "in one result only")
            if g is None:
                continue
            need(g.shape == w.shape and g.dtype == w.dtype,
                 f"{name} {what}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            prev = self.max[name]
            self.max[name] = err if prev is None else max(prev, err)
            need(torch.equal(g, w), f"{name} {what}: max |err| {err}")


def phase_kernels(errs: Errors):
    """Phase 1: each kernel against its plain version on the fixtures."""
    import numpy as np
    import torch

    from pollen_tpu_torch import parse_gfa_file
    from pollen_tpu_torch.device import _nibble_pack, build_graph
    from pollen_tpu_torch.kernels import crossmat as cm
    from pollen_tpu_torch.kernels import ellscan as ell

    rng = np.random.default_rng(0)
    graphs = sorted((REPO / "tests" / "graphs").glob("*.gfa"))
    need(len(graphs) == 8, f"expected 8 fixture graphs, found {len(graphs)}")
    for path in graphs:
        g = parse_gfa_file(str(path))
        os.environ["POLLEN_ELL_PACK16"] = "0"
        try:
            dg32 = build_graph(g, "cuda", cross_matrix="always")
        finally:
            del os.environ["POLLEN_ELL_PACK16"]
        dg16 = build_graph(g, "cuda", cross_matrix="always")
        need(dg16.ell_pack16 == 1 and dg32.ell_pack16 == 0, "pack16 layouts")
        # An int8 matrix from the same run index (clip 127).
        r = int(dg16.run_seg_bounds[-1])
        run_seg = np.repeat(
            np.arange(g.num_segments), np.diff(dg16.run_seg_bounds.cpu().numpy())
        )
        p_pad = -(-g.num_paths // 128) * 128
        n_pad = -(-g.num_segments // 128) * 128
        a8 = np.zeros((p_pad, n_pad), np.int8)
        a8[dg16.run_path[:r].cpu().numpy(), run_seg] = np.minimum(
            dg16.run_count[:r].cpu().numpy(), cm.CLIP
        )
        a8 = torch.from_numpy(a8).cuda()
        for _ in range(4):
            m = torch.from_numpy(rng.random(g.num_paths) < 0.5).cuda()
            mp = torch.zeros(p_pad, dtype=torch.int32, device="cuda")
            mp[: g.num_paths] = m.to(torch.int32)
            what = f"{path.name}"
            cross = dg16.cross_matrix
            nib = dg16.cross_nibble
            errs.compare(
                "cross (K2)",
                cm.masked_cross_depth(cross, m, nibble=nib),
                cm.masked_cross_depth_plain(cross, mp[: cross.shape[0] * (2 if nib else 1)], nibble=nib),
                what + " cross matrix",
            )
            errs.compare(
                "cross (K2)",
                [cm.masked_cross_depth(a8, m, nibble=False, uniq=False)],
                cm.masked_cross_depth_plain(a8, mp, nibble=False)[:1],
                what + " int8 depth-only",
            )
            errs.compare(
                "cross (K2)",
                cm.masked_cross_depth(a8, m, nibble=False),
                cm.masked_cross_depth_plain(a8, mp, nibble=False),
                what + " int8",
            )
            for dg in (dg16, dg32):
                tiers = [
                    (t, k)
                    for t, k in (
                        (dg.cross_ell, dg.ell_k),
                        (dg.cross_ell2, dg.ell_k2),
                        (dg.cross_ell3, dg.ell_k3),
                    )
                    if t.numel()
                ]
                p16 = bool(dg.ell_pack16)
                for t, k in tiers:
                    errs.compare(
                        "ell_tier (K3)",
                        ell.masked_ell_depth_tall(t, m, k, pack16=p16),
                        ell.masked_ell_depth_tall_plain(t, m, k, pack16=p16),
                        f"{what} tier k={k} pack16={p16}",
                    )
                args = (
                    [t for t, _ in tiers], dg.ell_heavy, m, [k for _, k in tiers]
                )
                errs.compare(
                    "ell_splitn (K1)",
                    ell.masked_ell_splitn_depth(*args, pack16=p16),
                    ell.masked_ell_splitn_depth_plain(*args, pack16=p16),
                    f"{what} fused pack16={p16}",
                )
        # The batched kernels at Q = 1, 5 (ragged), 32 and 40 (two query
        # chunks): K5 on a nibble and an int8 matrix from the run index;
        # K4 on 1, 2 and 3 tiers (the fixture's tiers, repeated where it
        # has fewer), with and without a heavy block (the fixture's own,
        # else the nibble matrix), pack16 and 32-bit slots.
        a4 = torch.from_numpy(
            _nibble_pack(
                dg16.run_path[:r].cpu().numpy(), run_seg,
                np.minimum(dg16.run_count[:r].cpu().numpy(), cm.CLIP_NIBBLE),
                p_pad, n_pad,
            )
        ).cuda()
        no_heavy = torch.zeros((0, 0), dtype=torch.uint8, device="cuda")
        for q in KERNEL_QS:
            ms = torch.from_numpy(
                rng.random((q, g.num_paths)) < rng.random((q, 1))
            ).cuda()
            for a, nib in ((a4, True), (a8, False)):
                errs.compare(
                    "cross_batch (K5)",
                    cm.batched_cross_depth(a, ms, nibble=nib),
                    cm.batched_cross_depth_plain(
                        a, cm.pad_mask(ms, p_pad), nibble=nib
                    ),
                    f"{path.name} Q={q} nibble={nib}",
                )
            for dg in (dg16, dg32):
                tiers = [
                    (t, k)
                    for t, k in (
                        (dg.cross_ell, dg.ell_k),
                        (dg.cross_ell2, dg.ell_k2),
                        (dg.cross_ell3, dg.ell_k3),
                    )
                    if t.numel()
                ]
                p16 = bool(dg.ell_pack16)
                heavy = dg.ell_heavy if dg.ell_heavy.numel() else a4
                for nt in (1, 2, 3):
                    use = [tiers[i % len(tiers)] for i in range(nt)]
                    for h in (heavy, no_heavy):
                        args = ([t for t, _ in use], h, ms, [k for _, k in use])
                        errs.compare(
                            "ell_splitn_batch (K4)",
                            ell.masked_ell_splitn_depth_batch(
                                *args, pack16=p16
                            ),
                            ell.masked_ell_splitn_depth_batch_plain(
                                *args, pack16=p16
                            ),
                            f"{path.name} Q={q} tiers={nt} "
                            f"heavy={bool(h.numel())} pack16={p16}",
                        )
    # K4 on tiers wider than its 8-word register bucket (run in chunks
    # that add into the outputs): random slot words, each bit pattern a
    # valid slot in both layouts.
    gen = torch.Generator().manual_seed(0)
    ms = torch.from_numpy(rng.random((40, 300)) < 0.5).cuda()
    for k in (11, 20):
        tall = torch.randint(-2**31, 2**31, (k * ell.SUB, ell.TALL_W),
                             dtype=torch.int32, generator=gen)
        tall[torch.rand(tall.shape, generator=gen) < 0.3] = 0
        tall = tall.cuda()
        for p16 in (False, True):
            args = ([tall], no_heavy, ms, [k])
            errs.compare(
                "ell_splitn_batch (K4)",
                ell.masked_ell_splitn_depth_batch(*args, pack16=p16),
                ell.masked_ell_splitn_depth_batch_plain(*args, pack16=p16),
                f"random tier k={k} pack16={p16}",
            )
    torch.cuda.synchronize()
    print("phase 1: kernels equal their plain versions on 8 fixtures, "
          "4 masks each, batches at Q = "
          f"{', '.join(map(str, KERNEL_QS))} (tolerance 0: exact integer "
          "counts)", flush=True)


# Edge checks of K1 and K4: paths (1, 33; 256 and 300 around pack16's
# limit; 4097, one past the 4096 whose query bits K4's blocks build
# themselves; 40000, path ids past 2^15) and K4's batch sizes (one
# tensor-core row tile is 16 queries, a chunk 32).
SPLIT_PS = (1, 33, 256, 300, 4097, 40000)
SPLIT_QS = (1, 7, 8, 31, 32, 33, 65)


def split_tier(rng, p, k, pack16):
    """A random tall tier of one row group: k stored words a column
    (pack16: two path<<8|count halves each), paths below p, counts up
    to the layout's limit, 30% of the slots empty."""
    import numpy as np
    import torch

    from pollen_tpu_torch.kernels import ellscan as ell

    n = ell.SUB * ell.TALL_W
    slots = 2 * k if pack16 else k
    v = (rng.integers(0, p, (slots, n)) << 16) | rng.integers(
        1, 256 if pack16 else 65536, (slots, n))
    v[rng.random(v.shape) < 0.3] = 0
    flat = (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    if pack16:
        flat = ell.pair_ell16(flat)
    return torch.from_numpy(ell.pack_ell_tall(flat)).cuda()


def check_split_repeats(errs: Errors, tiers, heavy, m, ms, ks, p16):
    """K1 and K4: 20 back-to-back calls, then two replays of a CUDA graph
    that captured one call (outputs wiped between), each equal to plain."""
    import torch

    from pollen_tpu_torch.kernels import ellscan as ell

    for name, fn, plain, mask in (
        ("ell_splitn (K1)", ell.masked_ell_splitn_depth,
         ell.masked_ell_splitn_depth_plain, m),
        ("ell_splitn_batch (K4)", ell.masked_ell_splitn_depth_batch,
         ell.masked_ell_splitn_depth_batch_plain, ms),
    ):
        call = functools.partial(fn, tiers, heavy, mask, ks, pack16=p16)
        want = plain(tiers, heavy, mask, ks, pack16=p16)
        outs = [call() for _ in range(20)]
        for i, got in enumerate(outs):
            errs.compare(name, got, want, f"back-to-back call {i}")
        del outs
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = call()
        for i in range(2):
            for c in got:
                if c is not None:
                    c.fill_(-1)
            graph.replay()
            torch.cuda.synchronize()
            errs.compare(name, got, want, f"CUDA graph replay {i}")
        del graph, got


def phase_kernels_split(errs: Errors):
    """Phase 1 (K1's and K4's edges), each call against its plain
    version, tolerance 0: random tiers at P = SPLIT_PS paths (pack16 and
    32-bit slots up to 256 paths, 32-bit past; masks of bytes and of
    int32) in five shapes (no tier columns, so the heavy block alone; one
    tier; two; three with one of 9 stored words, past the 8 a chunk holds;
    the three tiers alone), K4 at Q = SPLIT_QS; every heavy cell at its
    clip (15) under all-ones masks; a heavy block 4 bytes off a 16-byte
    boundary; 20 back-to-back calls and CUDA-graph replays."""
    import numpy as np
    import torch

    from pollen_tpu_torch.kernels import ellscan as ell

    rng = np.random.default_rng(7)
    no_heavy = torch.zeros((0, 0), dtype=torch.uint8, device="cuda")
    n_heavy = 384  # three tensor-core tiles; one K2 tile of 8 row groups

    def check(tiers, heavy, ks, p16, m, ms, what):
        for name, fn, plain, mask in (
            ("ell_splitn (K1)", ell.masked_ell_splitn_depth,
             ell.masked_ell_splitn_depth_plain, m),
            ("ell_splitn_batch (K4)", ell.masked_ell_splitn_depth_batch,
             ell.masked_ell_splitn_depth_batch_plain, ms),
        ):
            errs.compare(name, fn(tiers, heavy, mask, ks, pack16=p16),
                         plain(tiers, heavy, mask, ks, pack16=p16), what)

    for p in SPLIT_PS:
        rows = -(-p // 2)
        heavy = torch.from_numpy(
            rng.integers(0, 256, (rows, n_heavy)).astype(np.uint8)).cuda()
        for p16 in (True, False) if p <= 256 else (False,):
            dtype = torch.bool if p16 else torch.int32
            t1, t3, t9 = (split_tier(rng, p, k, p16) for k in (1, 3, 9))
            shapes = (
                ("heavy block alone", [t1[:0]], heavy, [1]),
                ("one tier", [t1], heavy, [1]),
                ("two tiers", [t1, t3], heavy, [1, 3]),
                ("three tiers, k = 9", [t1, t3, t9], heavy, [1, 3, 9]),
                ("three tiers alone", [t1, t3, t9], no_heavy, [1, 3, 9]),
            )
            for what, tiers, h, ks in shapes:
                for q in SPLIT_QS:
                    ms = torch.from_numpy(
                        rng.random((q, p)) < rng.random((q, 1))).to(dtype).cuda()
                    check(tiers, h, ks, p16, ms[0], ms,
                          f"P={p} pack16={p16} {what} Q={q}")
        if p == 300:
            repeat = ([t1, t3, t9], heavy, [1, 3, 9])
    # Every heavy cell at its clip under all-ones masks: depth 15 P and
    # uniq P in every heavy column, for both kernels.
    rows, p = 150, 300
    clip = torch.full((rows, 1024), 0xFF, dtype=torch.uint8, device="cuda")
    t1 = split_tier(rng, p, 1, False)
    for q in (1, 33):
        ones = torch.ones((q, p), dtype=torch.int32, device="cuda")
        check([t1], clip, [1], False, ones[0], ones, f"heavy clip, Q={q}")
        dh, uh = ell.masked_ell_splitn_depth_batch([t1], clip, ones, [1])[-2:]
        need(bool((dh == 15 * p).all()) and bool((uh == p).all()),
             f"K4 heavy clip Q={q}: depth {int(dh.max())}, uniq {int(uh.max())}")
    dh, uh = ell.masked_ell_splitn_depth([t1], clip, ones[0], [1])[-2:]
    need(bool((dh == 15 * p).all()) and bool((uh == p).all()),
         f"K1 heavy clip: depth {int(dh.max())}, uniq {int(uh.max())}")
    # A heavy block 4 bytes off a 16-byte boundary (4-byte loads, 4-byte
    # copies into shared memory).
    flat = torch.from_numpy(
        rng.integers(0, 256, rows * n_heavy + 4).astype(np.uint8)).cuda()
    off = flat[4:].view(rows, n_heavy)
    need(off.data_ptr() % 16 == 4, "expected a heavy block 4 bytes off 16")
    for q in (1, 40):
        ms = torch.from_numpy(rng.random((q, p)) < 0.5).cuda()
        check([t1], off, [1], False, ms[0], ms,
              f"heavy block 4 bytes off 16, Q={q}")
    tiers, heavy, ks = repeat
    ms = torch.from_numpy(rng.random((33, 300)) < 0.5).cuda()
    check_split_repeats(errs, tiers, heavy, ms[0], ms, ks, False)
    torch.cuda.synchronize()
    print("phase 1 (K1, K4): random tiers at P = "
          f"{', '.join(map(str, SPLIT_PS))} (pack16 and 32-bit), the heavy "
          "block alone, 1-3 tiers (one of 9 words), tiers alone, Q = "
          f"{', '.join(map(str, SPLIT_QS))}; the heavy clip under all-ones "
          "masks (15 P, P); a heavy block 4 bytes off 16; 20 back-to-back "
          "calls and two CUDA-graph replays: all equal plain (tolerance 0)",
          flush=True)


def phase_kernels_cross_batch(errs: Errors):
    """Phase 1 (K5's edges): every cell at its clip (15 nibble, 127
    int8) under all-ones masks, whose sums are known; int8 matrices of
    P = 2, 30, 33, 300 paths and nibble matrices of 2, 30, 66, 300 (the
    tensor-core K step is 32 paths, so all but one pad K with zeros);
    Q = 1, 5, 16, 17, 32, 40 (16: one mma row tile, 17: one over, 40:
    two query chunks); and a matrix that starts 4 bytes past a 16-byte
    boundary (4-byte copies into shared memory). Tolerance 0."""
    import numpy as np
    import torch

    from pollen_tpu_torch.kernels import crossmat as cm

    rng = np.random.default_rng(5)
    n_pad = 1024
    for nib, clip in ((True, cm.CLIP_NIBBLE), (False, cm.CLIP)):
        rows = 150 if nib else 300
        p = 2 * rows if nib else rows
        a = torch.full((rows, n_pad), 0xFF if nib else clip,
                       dtype=torch.uint8 if nib else torch.int8, device="cuda")
        for q in CROSS_QS:
            ones = torch.ones((q, p), dtype=torch.int32, device="cuda")
            d, u = cm.batched_cross_depth(a, ones, nibble=nib)
            errs.compare("cross_batch (K5)", (d, u),
                         cm.batched_cross_depth_plain(a, ones, nibble=nib),
                         f"every cell {clip}, nibble={nib}, Q={q}")
            need(bool((d == clip * p).all()) and bool((u == p).all()),
                 f"every cell {clip}, nibble={nib}, Q={q}: depth "
                 f"{int(d.max())}, uniq {int(u.max())}")
    for nib, paths in ((False, (2, 30, 33, 300)), (True, (2, 30, 66, 300))):
        for p in paths:
            rows = -(-p // 2) if nib else p
            if nib:
                a = rng.integers(0, 256, (rows, n_pad)).astype(np.uint8)
            else:
                a = rng.integers(0, cm.CLIP + 1, (rows, n_pad)).astype(np.int8)
            a[rng.random(a.shape) < 0.3] = 0
            a = torch.from_numpy(a).cuda()
            for q in CROSS_QS:
                ms = torch.from_numpy(
                    rng.random((q, p)) < rng.random((q, 1))
                ).cuda()
                errs.compare(
                    "cross_batch (K5)", cm.batched_cross_depth(a, ms, nibble=nib),
                    cm.batched_cross_depth_plain(
                        a, cm.pad_mask(ms, 2 * rows if nib else rows), nibble=nib
                    ),
                    f"P={p} nibble={nib} Q={q}",
                )
    for nib in (True, False):
        rows = 33
        flat = torch.from_numpy(
            rng.integers(0, 16 if nib else cm.CLIP + 1, rows * n_pad + 4)
            .astype(np.uint8 if nib else np.int8)
        ).cuda()
        a = flat[4:].view(rows, n_pad)
        need(a.data_ptr() % 16 == 4, "expected a matrix 4 bytes off 16")
        p = 2 * rows if nib else rows
        ms = torch.from_numpy(rng.random((17, p)) < 0.5).cuda()
        errs.compare("cross_batch (K5)", cm.batched_cross_depth(a, ms, nibble=nib),
                     cm.batched_cross_depth_plain(a, ms, nibble=nib),
                     f"matrix 4 bytes off 16, nibble={nib}")
    torch.cuda.synchronize()
    print("phase 1 (K5): every cell at the clip (15, 127) under all-ones "
          "masks gives 15 P and 127 P exactly; int8 P = 2, 30, 33, 300 and "
          "nibble P = 2, 30, 66, 300; a matrix 4 bytes off a 16-byte "
          f"boundary; Q = {', '.join(map(str, CROSS_QS))}; all equal plain "
          "(tolerance 0)", flush=True)


def phase_kernels_cross(errs: Errors):
    """Phase 1 (K2's edges): every cell at its clip (15 nibble, 127 int8)
    under all-ones masks, whose sums are known; byte rows 1, 13, 33
    (not a multiple of the 8 rows a thread has in flight), 100 (past 8
    row groups' one batch each) and 2,500 (past the 2,048-row list
    chunk); 128 columns (one tile, most lanes idle), 1,024
    and 4,736 (ragged tiles); a matrix 4 bytes off a 16-byte boundary
    (4-byte loads); int8 cells over the whole signed range; masks
    shorter and longer than the matrix's paths; both layouts, with and
    without uniq. Tolerance 0."""
    import numpy as np
    import torch

    from pollen_tpu_torch.kernels import crossmat as cm

    name = "cross (K2)"
    rng = np.random.default_rng(7)

    def check(a, m, nib, what):
        p = a.shape[0] * (2 if nib else 1)
        mp = cm.pad_mask(m, p)
        want = cm.masked_cross_depth_plain(a, mp, nibble=nib)
        errs.compare(name, cm.masked_cross_depth(a, m, nibble=nib), want, what)
        errs.compare(name, [cm.masked_cross_depth(a, m, nibble=nib, uniq=False)],
                     want[:1], what + ", depth only")
        return want

    for nib, clip in ((True, cm.CLIP_NIBBLE), (False, cm.CLIP)):
        for rows in (1, 13, 150, 300):
            p = 2 * rows if nib else rows
            a = torch.full((rows, 1024), 0xFF if nib else clip,
                           dtype=torch.uint8 if nib else torch.int8,
                           device="cuda")
            d, u = check(a, torch.ones(p, dtype=torch.int32, device="cuda"),
                         nib, f"every cell {clip}, {rows} rows")
            need(bool((d == clip * p).all()) and bool((u == p).all()),
                 f"K2 every cell {clip}, {rows} rows: depth {int(d.max())}, "
                 f"uniq {int(u.max())}")
    for nib in (True, False):
        for rows in (1, 13, 33, 100, 2500):
            for n_pad in (128, 1024, 4736):
                if rows == 2500 and n_pad != 1024:
                    continue
                if nib:
                    a = rng.integers(0, 256, (rows, n_pad)).astype(np.uint8)
                else:
                    a = rng.integers(-128, 128, (rows, n_pad)).astype(np.int8)
                a[rng.random(a.shape) < 0.3] = 0
                a = torch.from_numpy(a).cuda()
                p = 2 * rows if nib else rows
                for plen in (p, max(p - 3, 1), p + 40):
                    m = torch.from_numpy(rng.random(plen) < rng.random()).cuda()
                    check(a, m, nib, f"{rows} rows x {n_pad}, mask of {plen} "
                          f"paths, nibble={nib}")
        rows, n_pad = 33, 1024
        flat = torch.from_numpy(
            rng.integers(0, 256, rows * n_pad + 4).astype(np.uint8)
        ).cuda()
        a = flat[4:].view(rows, n_pad)
        if not nib:
            a = a.view(torch.int8)
        need(a.data_ptr() % 16 == 4, "expected a matrix 4 bytes off 16")
        check(a, torch.from_numpy(rng.random(66) < 0.5).cuda(), nib,
              f"matrix 4 bytes off 16, nibble={nib}")
    torch.cuda.synchronize()
    print("phase 1 (K2): every cell at the clip (15, 127) under all-ones "
          "masks gives 15 P and 127 P exactly; byte rows 1, 13, 33, 100, 2500 x "
          "128, 1024, 4736 columns; masks shorter and longer than P; int8 "
          "over -128..127; a matrix 4 bytes off a 16-byte boundary; both "
          "layouts, with and without uniq; all equal plain (tolerance 0)",
          flush=True)


def run_cli(argv, stdin_text=""):
    from pollen_tpu_torch import cli

    out = io.StringIO()
    cli.main(argv, stdin=io.StringIO(stdin_text), stdout=out)
    return out.getvalue()


def batch_file(tmp: pathlib.Path, path: pathlib.Path) -> pathlib.Path:
    """A ``depth -S`` file for a fixture: the golden subset comma-joined,
    then every path name."""
    from pollen_tpu_torch import parse_gfa_file

    names = [b.decode() for b in parse_gfa_file(str(path)).path_names()]
    subset = (REPO / "tests" / "golden" / f"{path.stem}.depthpaths")
    out = tmp / f"{path.stem}.batch"
    out.write_text(
        ",".join(subset.read_text().split()) + "\n" + " ".join(names) + "\n"
    )
    return out


def phase_goldens(tmp: pathlib.Path):
    """Phase 2: the user's entry points on the fixtures, on the card."""
    graphs = REPO / "tests" / "graphs"
    golden = REPO / "tests" / "golden"
    for path in sorted(graphs.glob("*.gfa")):
        stem = path.stem
        got = run_cli(["--device", "cuda", "-I", str(path), "depth", "-d"])
        need(got == (golden / f"{stem}.depth").read_text(),
             f"depth -d differs from the golden on {path.name}")
        got = run_cli([
            "--device", "cuda", "-I", str(path), "depth", "-d", "-s",
            str(golden / f"{stem}.depthpaths"),
        ])
        need(got == (golden / f"{stem}.depth_subset").read_text(),
             f"depth -d -s differs from the golden on {path.name}")
    subset = golden / "rand1.depthpaths"
    batch = batch_file(tmp, graphs / "rand1.gfa")
    requests = (f"depth -d -s {subset}\ndepth -d\ndepth -d -s {subset}\n"
                f"depth -d -S {batch}\n")
    text = run_cli(
        ["--device", "cuda", "-I", str(graphs / "rand1.gfa"), "serve"],
        requests,
    )
    frames = [ln for ln in text.splitlines() if ln.startswith("##end")]
    need(frames == ["##end\tok"] * 4, f"serve frames: {frames}")
    want = (golden / "rand1.depth_subset").read_text()
    need(text.startswith(want + "##end\tok\n"), "serve answer differs")
    want_batch = ("##query\t0\n" + want + "##query\t1\n"
                  + (golden / "rand1.depth").read_text())
    need(text.endswith(want_batch + "##end\tok\n"),
         "serve's depth -d -S answer differs")
    print("phase 2: goldens byte-identical on cuda for 8 fixtures "
          "(depth -d, depth -d -s); serve answered 4 requests ##end ok "
          "(one depth -d -S)", flush=True)


def phase_goldens_batch(tmp: pathlib.Path):
    """Phase 2 (batch): ``depth -d -S`` on every fixture, on the card,
    against the goldens of its two subsets."""
    golden = REPO / "tests" / "golden"
    for path in sorted((REPO / "tests" / "graphs").glob("*.gfa")):
        batch = batch_file(tmp, path)
        got = run_cli(["--device", "cuda", "-I", str(path), "depth", "-d",
                       "-S", str(batch)])
        want = ("##query\t0\n"
                + (golden / f"{path.stem}.depth_subset").read_text()
                + "##query\t1\n"
                + (golden / f"{path.stem}.depth").read_text())
        need(got == want, f"depth -d -S differs from the goldens on "
             f"{path.name}")
    print("phase 2 (batch): depth -d -S byte-identical to the goldens on "
          "cuda for 8 fixtures", flush=True)


def scale_masks(p, rng):
    import numpy as np

    masks = [np.ones(p, bool), np.arange(p) < p // 2, np.arange(p) % 2 == 0]
    masks += [rng.random(p) < f for f in (0.5, 0.5, 0.25, 0.75, 0.1)]
    return masks


class NumpyReference:
    """Masked (depth, uniq) from the run index alone, in numpy: an
    independent reference. The run arrays are copied to the host once."""

    def __init__(self, dg):
        import numpy as np

        rsb = dg.run_seg_bounds.cpu().numpy()
        r = int(rsb[-1])
        self.n = dg.num_segments
        self.run_seg = np.repeat(np.arange(self.n), np.diff(rsb))
        self.run_path = dg.run_path[:r].cpu().numpy()
        self.run_count = dg.run_count[:r].cpu().numpy()

    def __call__(self, mask):
        import numpy as np

        w = mask[self.run_path]
        depth = np.bincount(self.run_seg, w * self.run_count, minlength=self.n)
        uniq = np.bincount(self.run_seg, w, minlength=self.n)
        return depth.astype(np.int64), uniq.astype(np.int64)


def index_bytes(dg) -> int:
    return sum(
        t.numel() * t.element_size()
        for t in (
            dg.cross_ell, dg.cross_ell2, dg.cross_ell3, dg.ell_heavy,
            dg.ell_heavy_res, dg.ell_heavy_res_col,
        )
    )


def plan_of(dg) -> dict:
    return dict(
        ks=[k for k in (dg.ell_k, dg.ell_k2, dg.ell_k3) if k],
        pack16=dg.ell_pack16,
        tier_cols=[dg.ell_num_light, dg.ell_num_mid, dg.ell_num_mid2],
        heavy_cols=dg.ell_num_heavy,
        heavy_block=list(dg.ell_heavy.shape),
        fused=dg.ell_heavy.shape[1] % 8192 == 0,
        index_bytes=index_bytes(dg),
    )


def phase_scale(graphs: dict):
    """Phase 3 (main-path part): ingest and 8 routed queries per graph."""
    import numpy as np
    import torch

    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.ops import depth as depth_op
    from pollen_tpu_torch.synth import synth_graph

    rng = np.random.default_rng(8)
    for name, shape in SCALE.items():
        g = synth_graph(*shape)
        t0 = time.perf_counter()
        dg = build_graph(g, "cuda")
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        pick = depth_op._best_masked_impl(dg)
        need(pick == "ell", f"{name}: router picked {pick!r}, expected 'ell'")
        plan = plan_of(dg)
        print(f"{name}: {shape[0]} steps, {shape[1]} segments, {shape[2]} "
              f"paths; ingest {ingest_s:.3f} s; router {pick}; plan {plan}",
              flush=True)
        reference = NumpyReference(dg)
        before = launch_counts()
        names = [b.decode() for b in g.path_names()]
        for i, m in enumerate(scale_masks(g.num_paths, rng)):
            mt = torch.from_numpy(m)
            d, u = depth_op.masked_seg_depth(dg, mt)
            d_ref, u_ref = reference(m)
            need(np.array_equal(d, d_ref) and np.array_equal(u, u_ref),
                 f"{name} mask {i}: differs from the numpy reference")
            d_pl, u_pl = depth_op.seg_depth_with_uniq_ell(
                dg, mt.cuda(), plain=True
            )
            need(np.array_equal(d, d_pl.numpy())
                 and np.array_equal(u, u_pl.numpy()),
                 f"{name} mask {i}: differs from the plain torch path")
            if i == 1:
                text = depth_op.run_seg_depth(
                    g, dg, [n for n, keep in zip(names, m) if keep]
                )
                need(text == depth_op.seg_depth_table(g, d_ref, u_ref),
                     f"{name}: depth -d -s table differs")
        after = launch_counts()
        moved = {k: after[k] - before[k] for k in after}
        key = "ell_splitn" if plan["fused"] else "ell_tier"
        need(moved[key] >= 8, f"{name}: {key} launches {moved}")
        print(f"{name}: 8 masks equal numpy reference and plain torch; "
              f"launches {moved}", flush=True)
        graphs[name] = (g, dg, reference)


def batch_masks(p, rng):
    """The 8 scale masks plus 24 seeded draws of varied density: Q = 32."""
    import numpy as np

    draws = rng.random((24, p)) < rng.random((24, 1))
    return np.concatenate([np.stack(scale_masks(p, rng)), draws])


def phase_scale_batch(graphs: dict) -> dict:
    """Phase 3 (batch): Q = 32 masks through the routed batch query on
    the scale graphs, plus bench under a batch plan (32-bit slots), under
    the single-query plan with 32-bit slots, and bench's crossing matrix
    alone (the routed cross batch). Returns {name: (graph, device graph,
    route)}."""
    import dataclasses

    import numpy as np
    import torch

    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.ops import depth as depth_op

    g_bench, _, ref_bench = graphs["bench"]
    dg_batch = build_graph(g_bench, "cuda", ell_objective="batch")
    need(dg_batch.ell_pack16 == 0 and dg_batch.cross_ell.numel(),
         "bench_batch: expected a 32-bit ELL plan")
    os.environ["POLLEN_ELL_PACK16"] = "0"
    try:
        dg_32 = build_graph(g_bench, "cuda")
    finally:
        del os.environ["POLLEN_ELL_PACK16"]
    need(dg_32.ell_pack16 == 0, "bench_32bit: expected 32-bit slots")
    for name, dg in (("bench_batch", dg_batch), ("bench_32bit", dg_32)):
        print(f"{name}: plan {plan_of(dg)}", flush=True)
    # bench with its dense matrix forced resident and the ELL index
    # dropped: the batch router then takes the crossing matrix.
    dg_cross = build_graph(g_bench, "cuda", cross_matrix="always")
    dg_cross = dataclasses.replace(
        dg_cross, cross_ell=dg_cross.cross_ell[:0]
    )
    batch = {
        "bench": graphs["bench"],
        "bench_batch": (g_bench, dg_batch, ref_bench),
        "bench_32bit": (g_bench, dg_32, ref_bench),
        "bench_p300": graphs["bench_p300"],
        "chr8_third": graphs["chr8_third"],
        "bench_cross": (g_bench, dg_cross, ref_bench),
    }
    rng = np.random.default_rng(32)
    out = {}
    for name, (g, dg, reference) in batch.items():
        route = depth_op.batch_route(dg)
        want = "cross" if name == "bench_cross" else "ell"
        need(route == want, f"{name}: batch route {route!r}, want {want!r}")
        masks = batch_masks(g.num_paths, rng)
        mt = torch.from_numpy(masks)
        before = launch_counts()
        d, u = depth_op.seg_depth_with_uniq_batch(dg, mt)
        after = launch_counts()
        need(d.shape == (32, g.num_segments), f"{name}: shape {d.shape}")
        for i, m in enumerate(masks):
            d_ref, u_ref = reference(m)
            need(np.array_equal(d[i], d_ref) and np.array_equal(u[i], u_ref),
                 f"{name} batch row {i}: differs from the numpy reference")
        if route == "ell":
            d_pl, u_pl = depth_op.seg_depth_with_uniq_ell_batch(
                dg, mt.cuda(), plain=True
            )
        else:
            d_pl, u_pl = (
                x.cpu().numpy()
                for x in depth_op.seg_depth_with_uniq_cross_batch(
                    dg, mt.cuda(), plain=True
                )
            )
        need(np.array_equal(d, d_pl) and np.array_equal(u, u_pl),
             f"{name}: batch differs from the plain torch path")
        moved = {k: after[k] - before[k] for k in after}
        key = "ell_splitn_batch" if route == "ell" else "cross_batch"
        need(moved[key] >= 1, f"{name}: {key} launches {moved}")
        print(f"{name}: Q=32 batch ({route}) equals numpy reference row by "
              f"row and plain torch; launches {moved}", flush=True)
        out[name] = (g, dg, route)
    return out


def phase_batch_timing(batch: dict, card: str):
    """Phase 3 (batch timing): the batched parts call at Q = 1, 8, 16,
    32, kernels against plain: CUDA-event wall and profiler busy time."""
    import numpy as np
    import torch

    from pollen_tpu_torch.ops import depth as depth_op

    rng = np.random.default_rng(2)
    for name, (g, dg, route) in batch.items():
        parts = (
            depth_op.seg_depth_with_uniq_ell_batch_parts
            if route == "ell"
            else depth_op.seg_depth_with_uniq_cross_batch
        )
        masks = torch.from_numpy(batch_masks(g.num_paths, rng)).cuda()
        for q in TIMING_QS:
            wall, busy = [], []
            for plain in (False, True):
                fn = functools.partial(parts, dg, masks[:q], plain=plain)
                wall.append(cuda_ms(fn) * 1e3)
                busy.append(sum(device_profile(fn, reps=5).values()))
            (wk, wp), (bk, bp) = wall, busy
            idle = f"{1 - bk / wk:.3f}" if bk else "not measured"
            print(f"batch {name} Q={q} [{card}]: kernels wall {wk:.2f} us "
                  f"({wk / q:.2f} us/query, "
                  f"{q * g.num_steps / (wk * 1e-6) / 1e9:.2f} G steps/s), "
                  f"busy {bk:.2f} us, idle share {idle}; plain wall "
                  f"{wp:.2f} us ({wp / q:.2f} us/query), busy {bp:.2f} us",
                  flush=True)


def phase_timing(graphs: dict, batch: dict, errs: Errors, card: str) -> dict:
    """Phase 3 (timing): one query and each kernel, kernel vs plain (K5
    first held against plain at full size under a seeded batch)."""
    import numpy as np
    import torch

    from pollen_tpu_torch.kernels import crossmat as cm
    from pollen_tpu_torch.kernels import ellscan as ell
    from pollen_tpu_torch.ops import depth as depth_op

    rng = np.random.default_rng(1)
    for name, (g, dg, _) in graphs.items():
        m = torch.from_numpy(rng.random(g.num_paths) < 0.5).cuda()
        k_ms = cuda_ms(lambda: depth_op.seg_depth_with_uniq_ell_parts(dg, m))
        p_ms = cuda_ms(
            lambda: depth_op.seg_depth_with_uniq_ell_parts(dg, m, plain=True)
        )
        steps = g.num_steps
        prof_k = device_profile(
            lambda: depth_op.seg_depth_with_uniq_ell_parts(dg, m)
        )
        print(f"{name}: query with kernels, {describe_profile(prof_k)}; "
              f"idle share "
              f"{1 - sum(prof_k.values()) / (k_ms * 1e3):.3f}" if prof_k
              else f"{name}: {describe_profile(prof_k)}", flush=True)
        print(f"{name} [{card}]: query {k_ms * 1e3:.2f} us "
              f"({steps / (k_ms * 1e-3) / 1e9:.2f} G steps/s) with kernels; "
              f"{p_ms * 1e3:.2f} us ({steps / (p_ms * 1e-3) / 1e9:.2f} "
              f"G steps/s) plain; index {index_bytes(dg) / 2**20:.2f} MB "
              f"sits in the {L2_BYTES // 2**20} MB L2", flush=True)

    times = {}
    _, dg, _ = graphs["bench"]
    m = torch.from_numpy(rng.random(dg.num_paths) < 0.5).cuda()
    m32 = torch.from_numpy(batch_masks(dg.num_paths, rng)).cuda()
    times.update(split_rows(errs, dg, m, m32, "bench", ""))
    _, dg8, _ = graphs["chr8_third"]
    m8 = torch.from_numpy(rng.random(dg8.num_paths) < 0.5).cuda()
    m8_32 = torch.from_numpy(batch_masks(dg8.num_paths, rng)).cuda()
    times.update(split_rows(errs, dg8, m8, m8_32, "chr8_third",
                            ", chr8_third"))
    _, dgu, _ = graphs["unfused"]
    mu = torch.from_numpy(rng.random(dgu.num_paths) < 0.5).cuda()
    mpu = torch.zeros(dgu.ell_heavy.shape[0] * 2, dtype=torch.int32,
                      device="cuda")
    mpu[: dgu.num_paths] = mu.to(torch.int32)
    hu = dgu.ell_heavy
    # K2's one-call form: a float32 product of the folded mask by
    # [A | min(A, 1)], unpacked ahead of time (depth and uniq).
    au = both_products(cm.unpack_cross(hu)).float()
    fmu = cm.fold_mask(mpu).float()[None]
    times["cross (K2)"] = (
        lambda: cm.masked_cross_depth(hu, mu, nibble=True),
        lambda: cm.masked_cross_depth_plain(hu, mpu, nibble=True),
        f"unfused heavy block {tuple(hu.shape)}",
        bound(hu.numel() + dgu.num_paths + 8 * hu.shape[1],
              tensor_ops=4 * 2 * hu.numel()),
        lambda: torch.matmul(fmu, au),
    )
    p16u = bool(dgu.ell_pack16)
    tu = dgu.cross_ell
    tier_call = functools.partial(ell.masked_ell_depth_tall, tu, mu, dgu.ell_k,
                                  p16u)
    times["ell_tier (K3)"] = (
        tier_call,
        lambda: ell.masked_ell_depth_tall_plain(tu, mu, dgu.ell_k, p16u),
        "unfused tier 1",
        bound(4 * tu.numel() + dgu.num_paths + 8 * (tu.numel() // dgu.ell_k),
              core_ops=4 * tu.numel() * (2 if p16u else 1)),
        ell_library("ell_tier (K3)", tier_call, mu, dgu.num_paths,
                    tiers=[tu], ks=[dgu.ell_k], pack16=p16u),
    )
    dgc = batch["bench_cross"][1]
    nib = dgc.cross_nibble
    ac = dgc.cross_matrix
    p_c = ac.shape[0] * (2 if nib else 1)
    # A full-size check under a seeded random Q = 32 batch, outside the
    # timed calls.
    m_rand = torch.from_numpy(
        rng.random((32, dgc.num_paths)) < rng.random((32, 1))
    ).cuda()
    errs.compare("cross_batch (K5)", cm.batched_cross_depth(ac, m_rand, nibble=nib),
                 cm.batched_cross_depth_plain(ac, cm.pad_mask(m_rand, p_c),
                                              nibble=nib),
                 f"bench crossing matrix {tuple(ac.shape)}, seeded Q=32")
    mpc = cm.pad_mask(m32, p_c)
    # K5's one-call form: torch._int_mm of the folded int8 masks by the
    # int8 [A | min(A, 1)], both built ahead of time (float32
    # torch.matmul over the same where this build's _int_mm refuses).
    a_both = both_products(cm.unpack_cross(ac) if nib else ac.to(torch.int32))
    fm8 = (cm.fold_mask(mpc) if nib else mpc).to(torch.int8)
    library, lib_form = int_mm_or_matmul(fm8, a_both.to(torch.int8))
    print(f"K5's library call: {lib_form}", flush=True)
    times["cross_batch (K5)"] = (
        lambda: cm.batched_cross_depth(ac, m32, nibble=nib),
        lambda: cm.batched_cross_depth_plain(ac, mpc, nibble=nib),
        f"bench crossing matrix {tuple(ac.shape)}, Q=32",
        bound(ac.numel() + 32 * dgc.num_paths + 8 * 32 * ac.shape[1],
              tensor_ops=4 * 32 * ac.numel() * (2 if nib else 1)),
        library,
    )
    return time_kernels(times, card)


def ell_library(name, kern, masks, n_paths, **index):
    """The ELL family's one-call form (``probes.yardstick``): one
    torch.sparse.mm of the CSR counts of the cells the kernel reads by
    the float32 masks, both made ahead of time; first held against the
    kernel's outputs (exact: sums below 2^24)."""
    import torch

    from pollen_tpu_torch.probes import yardstick as ys

    csr, cols = ys.ell_csr(n_paths, **index)
    mt = ys.masks_for(masks)
    d, u = ys.depth_uniq(ys.ell_yardstick(csr, mt), cols)
    got = [x for x in kern() if x is not None]
    want_d = torch.cat([x if x.dim() == 2 else x[None] for x in got[0::2]], 1)
    want_u = torch.cat([x if x.dim() == 2 else x[None] for x in got[1::2]], 1)
    need(torch.equal(d, want_d) and torch.equal(u, want_u),
         f"{name}: the sparse-product yardstick differs from the kernel")
    print(f"{name}: yardstick torch.sparse.mm, CSR float32 {tuple(csr.shape)} "
          f"with {csr.values().numel()} entries x ({n_paths}, "
          f"{mt.shape[1]}) masks", flush=True)
    return functools.partial(ys.ell_yardstick, csr, mt)


def split_rows(errs: Errors, dg, m, m32, where, suffix) -> dict:
    """K1 under one mask and K4 under the Q = 32 masks on a graph's split
    ELL index: (kernel, plain, where, bound, library) rows, after holding
    each call against its plain version and checking that the profiler
    sees it as its one kernel launch (no packing launch ahead)."""
    from pollen_tpu_torch.kernels import ellscan as ell

    tiers = [t for t in (dg.cross_ell, dg.cross_ell2, dg.cross_ell3) if t.numel()]
    ks = [k for k in (dg.ell_k, dg.ell_k2, dg.ell_k3) if k]
    heavy, p16, q = dg.ell_heavy, bool(dg.ell_pack16), m32.shape[0]
    index = dict(tiers=tiers, ks=ks, pack16=p16, heavy=heavy)
    slots = sum(t.numel() for t in tiers) * (2 if p16 else 1)
    cols = sum(t.numel() // k for t, k in zip(tiers, ks)) + heavy.shape[1]
    in_bytes = 4 * sum(t.numel() for t in tiers) + heavy.numel()
    cells = 2 * heavy.numel()  # nibble: two paths a byte
    rows = {}
    for name, kern, plain, masks, n_q, kernel in (
        (f"ell_splitn (K1){suffix}",
         functools.partial(ell.masked_ell_splitn_depth, tiers, heavy, m, ks,
                           pack16=p16),
         functools.partial(ell.masked_ell_splitn_depth_plain, tiers, heavy, m,
                           ks, pack16=p16),
         m, 1, "ell_splitn_kernel"),
        (f"ell_splitn_batch (K4){suffix}",
         functools.partial(ell.masked_ell_splitn_depth_batch, tiers, heavy, m32,
                           ks, pack16=p16),
         functools.partial(ell.masked_ell_splitn_depth_batch_plain, tiers,
                           heavy, m32, ks, pack16=p16),
         m32, q, "ell_splitn_batch_kernel"),
    ):
        errs.compare(name, kern(), plain(), f"{where}, Q={n_q}")
        prof = device_profile(kern, reps=5)
        print(f"{name} call at {where}: {describe_profile(prof)}", flush=True)
        need(not prof or set(prof) == {kernel},
             f"{name} is not one {kernel} launch: {sorted(prof)}")
        rows[name] = (
            kern, plain, where if n_q == 1 else f"{where}, Q={n_q}",
            bound(in_bytes + n_q * dg.num_paths + 8 * n_q * cols,
                  core_ops=4 * slots * n_q, tensor_ops=4 * cells * n_q),
            ell_library(name, kern, masks, dg.num_paths, **index),
        )
    return rows


def both_products(a):
    """[A | min(A, 1)] along the columns: one product by it gives depth
    and uniq, what K2 and K5 compute."""
    import torch

    return torch.cat([a, torch.clamp(a, max=1)], dim=1)


def int_mm_or_matmul(m8, a8):
    """(one-call product, its name): torch._int_mm(m8, a8) if this
    build takes the shape, else float32 torch.matmul of the same."""
    import torch

    try:
        torch._int_mm(m8, a8)
        torch.cuda.synchronize()
        return (lambda: torch._int_mm(m8, a8)), "torch._int_mm, int8 x int8 -> int32"
    except RuntimeError as exc:
        mf, af = m8.float(), a8.float()
        reason = str(exc).splitlines()[0][:120]
        return (lambda: torch.matmul(mf, af)), (
            f"float32 torch.matmul (torch._int_mm refused: {reason})"
        )


def time_kernels(times: dict, card: str) -> dict:
    """Each kernel against its plain version (CUDA-event wall per call,
    runs plain, kernel, kernel, plain) and its library call; the device
    time per call of the kernel and of the library call from a replayed
    CUDA graph (``probes.timing.replay_us``), and the profiler's
    breakdown by kernel beside."""
    import torch

    from pollen_tpu_torch.probes.timing import replay_us

    out = {}
    for name, (kern, plain, where, bnd, library) in times.items():
        got, want = kern(), plain()
        for a, b in zip(got if isinstance(got, tuple) else [got], want):
            need((a is None and b is None) or torch.equal(a, b),
                 f"{name} at {where}: kernel != plain")
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                          cuda_ms(plain))
        lib_ms = None if library is None else cuda_ms(library)
        dev_ms = replay_us(kern) / 1e3
        lib_dev_ms = None if library is None else replay_us(library) / 1e3
        bound_ms, bound_by = bnd
        out[name] = dict(
            ms=min(k1, k2), plain_ms=min(p1, p2), bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms, device_ms=dev_ms,
            library_device_ms=lib_dev_ms, where=where,
        )
        print(f"{name} at {where}: kernel call, "
              f"{describe_profile(device_profile(kern))}; plain call, "
              f"{describe_profile(device_profile(plain, reps=10))}", flush=True)
        lib = ("none" if library is None else
               f"{lib_ms * 1e3:.2f} us wall, {lib_dev_ms * 1e3:.2f} us device")
        print(f"{name} at {where} [{card}]: kernel {min(k1, k2) * 1e3:.2f} us "
              f"wall, {dev_ms * 1e3:.2f} us device (graph replay); plain "
              f"{min(p1, p2) * 1e3:.2f} us wall (runs plain, kernel, kernel, "
              f"plain: {p1 * 1e3:.2f} {k1 * 1e3:.2f} {k2 * 1e3:.2f} "
              f"{p2 * 1e3:.2f} us); bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}); library call {lib}", flush=True)
    return out


def scan_case(s, p, n, seed):
    """A (segment, path)-sorted step list of s steps over p paths and n
    segments: (path ids, group starts, segment bounds), int32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, n, s)).astype(np.int32)
    path = rng.integers(0, p, s).astype(np.int32)
    order = np.lexsort((path, seg))
    seg, path = seg[order], path[order]
    new = np.concatenate(([True], (seg[1:] != seg[:-1]) | (path[1:] != path[:-1])))
    starts = np.flatnonzero(new)
    run_start = starts[np.cumsum(new) - 1].astype(np.int32)
    bounds = np.searchsorted(seg, np.arange(n + 1)).astype(np.int32)
    return path, run_start, bounds


def compare_scans(errs, name, kernel, plain, args, bounds, what):
    """A scan kernel (K6 or K8) on ``args``, then K7 on its two cumsums
    and on one, each against its plain version."""
    from pollen_tpu_torch.kernels import gatherb

    want = plain(*args)
    errs.compare(name, kernel(*args), want, what)
    if bounds is not None:
        for csums, how in ((want, ""), (want[:1], " (one cumsum)")):
            errs.compare(
                "boundary (K7)", gatherb.gather_boundary_diff(csums, bounds),
                gatherb.gather_boundary_diff_plain(csums, bounds), what + how,
            )


def phase_kernels_scan(errs: Errors):
    """Phase 1 (scan family): K6, K7, K8 against their plain versions."""
    import numpy as np
    import torch

    from pollen_tpu_torch import parse_gfa_file
    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.kernels import runscan, segscan

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()

    def seg(ids, rs, bounds, m, what, head_carry=0):
        compare_scans(errs, "seg_scan (K6)", segscan.masked_depth_cumsums,
                      segscan.masked_depth_cumsums_plain,
                      (ids, rs, m, head_carry), bounds, what)

    def run(ids, counts, bounds, m, what):
        compare_scans(errs, "run_scan (K8)", runscan.masked_run_cumsums,
                      runscan.masked_run_cumsums_plain, (ids, counts, m),
                      bounds, what)

    rng = np.random.default_rng(6)
    for path in sorted((REPO / "tests" / "graphs").glob("*.gfa")):
        g = parse_gfa_file(str(path))
        dg = build_graph(g, "cuda")
        for _ in range(4):
            m = cuda(rng.random(g.num_paths) < 0.5)
            seg(dg.step_path_sorted, dg.run_start, dg.seg_bounds, m,
                f"{path.name} steps")
            run(dg.run_path, dg.run_count, dg.run_seg_bounds, m,
                f"{path.name} runs")
    for i, p in enumerate(SCAN_PS):
        blocks = 1 + i % 3
        ids, rs, bounds = scan_case(blocks * SCAN_BLOCK, p, 37 + i, i)
        counts = rng.integers(1, 300, ids.shape[0]).astype(np.int32)
        for _ in range(4):
            m = cuda(rng.random(p) < rng.random())
            what = f"P={p}, {blocks} scan blocks"
            seg(cuda(ids), cuda(rs), cuda(bounds), m, what)
            run(cuda(ids), cuda(counts), cuda(bounds), m, what)
    # One group across three scan blocks (24 kernel tiles), and one of
    # 2^23 steps: several tiles per kernel block.
    for s in (3 * SCAN_BLOCK, 2**23):
        ids = cuda(np.zeros(s, np.int32))
        rs = cuda(np.zeros(s, np.int32))
        ends = cuda(np.array([0, s], np.int32))
        m = cuda(np.ones(1, np.int32))
        seg(ids, rs, ends, m, f"one group of {s} steps")
        d, u = segscan.depth_uniq_from_cumsums(
            *segscan.masked_depth_cumsums(ids, rs, m), ends
        )
        need((int(d[0]), int(u[0])) == (s, 1),
             f"one group of {s} steps: depth {int(d[0])}, uniq {int(u[0])}")
    # A shard's head carry: the leading group began 5 steps to the left
    # (negative group starts); later groups start inside, one across the
    # boundary of the first scan block.
    for hc in (0, 1, 2):
        ids = np.full(2 * SCAN_BLOCK, 3, np.int32)
        rs = np.full(2 * SCAN_BLOCK, -5, np.int32)
        for start in (700, SCAN_BLOCK - 300, SCAN_BLOCK + 4000):
            ids[start:] = rng.integers(0, 8)
            rs[start:] = start
        for _ in range(4):
            mk = (rng.random(8) < 0.5).astype(np.int32)
            mk[3] = 1
            seg(cuda(ids), cuda(rs), None, cuda(mk), f"head carry {hc}", hc)
    check_seg_scan_lookback(errs)
    check_run_scan_lookback(errs)
    torch.cuda.synchronize()
    print("phase 1 (scan family): K6, K7, K8 equal their plain versions on "
          f"8 fixtures and P = {', '.join(map(str, SCAN_PS))} (1-3 scan "
          "blocks), a group across three blocks and of 2^23 steps, head "
          "carry 0-2; 4 masks each; K6's look-back on 2^25 steps (one "
          "group, and a group start every 7 steps), 20 back-to-back calls "
          "and two replays of a captured CUDA graph; K8's the same at 2^25 "
          "runs (all-ones mask, weighted sum wrapping past 2^31; seeded "
          "runs over 5,000 paths) (tolerance 0: exact int32)", flush=True)


def check_seg_scan_lookback(errs: Errors):
    """K6's single pass at 2^25 steps: one group under the all-ones mask
    (no partition starts a group, so a look-back walks across many
    predecessors' aggregates), and a group start every 7 steps, each
    with head carry 0 and 2; then 20 back-to-back calls on one input and
    two replays of a CUDA graph that captured one call (the ticket
    counter and look-back descriptors reset inside it), each equal to
    plain."""
    import torch

    from pollen_tpu_torch.kernels import segscan

    n = 2**25
    pos = torch.arange(n, dtype=torch.int32, device="cuda")
    # Both leading groups began to the left (negative run_start), so the
    # head carry decides whether their first selected step counts here.
    cases = (
        ("one group of 2^25 steps", torch.zeros_like(pos),
         torch.full_like(pos, -5),
         torch.ones(1, dtype=torch.int32, device="cuda")),
        ("a group start every 7 steps", (pos + 3) // 7 % 5,
         pos - (pos + 3) % 7,
         torch.tensor([1, 0, 1, 1, 0], dtype=torch.int32, device="cuda")),
    )
    for what, path, rs, m in cases:
        for hc in (0, 2):
            errs.compare("seg_scan (K6)",
                         segscan.masked_depth_cumsums(path, rs, m, hc),
                         segscan.masked_depth_cumsums_plain(path, rs, m, hc),
                         f"{what}, head carry {hc}")
    _, path, rs, m = cases[1]
    want = segscan.masked_depth_cumsums_plain(path, rs, m)
    outs = [segscan.masked_depth_cumsums(path, rs, m) for _ in range(20)]
    for i, got in enumerate(outs):
        errs.compare("seg_scan (K6)", got, want, f"back-to-back call {i}")
    del outs
    fn = functools.partial(segscan.masked_depth_cumsums, path, rs, m)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    for i in range(2):
        for c in got:
            c.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        errs.compare("seg_scan (K6)", got, want, f"CUDA graph replay {i}")
    del graph, got


def check_run_scan_lookback(errs: Errors):
    """K8's single pass at 2^25 runs: under the all-ones mask with
    counts whose weighted sum passes 2^31 and wraps (every look-back
    walks across many predecessors' aggregates), and on seeded paths and
    counts with a random mask; then 20 back-to-back calls on one input
    and two replays of a CUDA graph that captured one call, each equal
    to plain."""
    import torch

    from pollen_tpu_torch.kernels import runscan

    n = 2**25
    gen = torch.Generator(device="cuda").manual_seed(11)
    path = torch.zeros(n, dtype=torch.int32, device="cuda")
    count = torch.full((n,), 100, dtype=torch.int32, device="cuda")
    ones = torch.ones(1, dtype=torch.int32, device="cuda")
    wc, w = runscan.masked_run_cumsums(path, count, ones)
    errs.compare("run_scan (K8)", (wc, w),
                 runscan.masked_run_cumsums_plain(path, count, ones),
                 "2^25 runs, all-ones mask, weighted sum past 2^31")
    need(int(w[-1]) == n and int(wc[-1]) == (100 * n + 2**31) % 2**32 - 2**31,
         f"K8 at 2^25 runs: last sums {int(wc[-1])}, {int(w[-1])}")
    del wc, w
    path = torch.randint(0, 5000, (n,), dtype=torch.int32, device="cuda",
                         generator=gen)
    count = torch.randint(1, 2**16, (n,), dtype=torch.int32, device="cuda",
                          generator=gen)
    m = torch.rand(5000, device="cuda", generator=gen) < 0.5
    want = runscan.masked_run_cumsums_plain(path, count, m)
    errs.compare("run_scan (K8)", runscan.masked_run_cumsums(path, count, m),
                 want, "2^25 seeded runs over 5,000 paths")
    outs = [runscan.masked_run_cumsums(path, count, m) for _ in range(20)]
    for i, got in enumerate(outs):
        errs.compare("run_scan (K8)", got, want, f"back-to-back call {i}")
    del outs
    fn = functools.partial(runscan.masked_run_cumsums, path, count, m)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    for i in range(2):
        for c in got:
            c.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        errs.compare("run_scan (K8)", got, want, f"CUDA graph replay {i}")
    del graph, got


def phase_goldens_scan(tmp: pathlib.Path):
    """Phase 2 (scan family): with the ELL and crossing-matrix indexes
    budgeted away, ``depth -d -s`` routes "scan" and ``depth -d -S``
    routes "runs"; both print the goldens, through the CLI and serve."""
    from pollen_tpu_torch import parse_gfa_file
    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.ops import depth as depth_op

    graphs = REPO / "tests" / "graphs"
    golden = REPO / "tests" / "golden"
    os.environ["POLLEN_CROSS_BUDGET_MB"] = "0"
    try:
        for path in sorted(graphs.glob("*.gfa")):
            stem = path.stem
            dg = build_graph(parse_gfa_file(str(path)), "cpu")
            need(depth_op._best_masked_impl(dg) == "scan"
                 and depth_op.batch_route(dg) == "runs",
                 f"{path.name}: budget 0 does not route scan / runs")
            got = run_cli([
                "--device", "cuda", "-I", str(path), "depth", "-d", "-s",
                str(golden / f"{stem}.depthpaths"),
            ])
            need(got == (golden / f"{stem}.depth_subset").read_text(),
                 f"scan route: depth -d -s differs from the golden on "
                 f"{path.name}")
            got = run_cli(["--device", "cuda", "-I", str(path), "depth", "-d",
                           "-S", str(batch_file(tmp, path))])
            want = ("##query\t0\n"
                    + (golden / f"{stem}.depth_subset").read_text()
                    + "##query\t1\n" + (golden / f"{stem}.depth").read_text())
            need(got == want, f"runs route: depth -d -S differs from the "
                 f"goldens on {path.name}")
        subset = golden / "rand1.depthpaths"
        batch = batch_file(tmp, graphs / "rand1.gfa")
        text = run_cli(
            ["--device", "cuda", "-I", str(graphs / "rand1.gfa"), "serve"],
            f"depth -d -s {subset}\ndepth -d -S {batch}\n",
        )
    finally:
        del os.environ["POLLEN_CROSS_BUDGET_MB"]
    want = (golden / "rand1.depth_subset").read_text()
    need(text == want + "##end\tok\n##query\t0\n" + want + "##query\t1\n"
         + (golden / "rand1.depth").read_text() + "##end\tok\n",
         "scan-family serve answers differ")
    print("phase 2 (scan family): under POLLEN_CROSS_BUDGET_MB=0, depth -d "
          "-s (scan) and depth -d -S (runs) byte-identical to the goldens on "
          "cuda for 8 fixtures; serve answered one of each ##end ok",
          flush=True)


def phase_scale_scan() -> dict:
    """Phase 3 (scan family): ingest, 8 routed masks and a Q = 32 batch
    per graph, against plain torch on the card and the numpy reference.
    Returns {name: (graph, device graph, route)}."""
    import numpy as np
    import torch

    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.ops import depth as depth_op
    from pollen_tpu_torch.synth import synth_graph

    rng = np.random.default_rng(8)
    out = {}
    for name, (shape, ingest, route) in SCAN_SCALE.items():
        g = synth_graph(*shape)
        t0 = time.perf_counter()
        dg = build_graph(g, "cuda", **ingest)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        pick = depth_op._best_masked_impl(dg)
        need(pick == route, f"{name}: router picked {pick!r}, want {route!r}")
        need(depth_op.batch_route(dg) == "runs", f"{name}: batch route")
        state = sum(getattr(dg, f).numel() * getattr(dg, f).element_size()
                    for f in ("step_path_sorted", "run_start", "seg_bounds",
                              "run_path", "run_count", "run_seg_bounds"))
        print(f"{name}: {shape[0]} steps, {shape[1]} segments, {shape[2]} "
              f"paths; ingest {ingest_s:.3f} s; router {pick}; steps padded "
              f"{dg.padded_steps}, runs padded {dg.run_path.shape[0]}; scan "
              f"state {state / 1e9:.3f} GB", flush=True)
        reference = NumpyReference(dg)
        fused = (depth_op.seg_depth_with_uniq_fused if route == "scan"
                 else depth_op.seg_depth_with_uniq_runs_fused)
        before = launch_counts()
        names = [b.decode() for b in g.path_names()]
        for i, m in enumerate(scale_masks(g.num_paths, rng)):
            mt = torch.from_numpy(m)
            d, u = depth_op.masked_seg_depth(dg, mt)
            d_ref, u_ref = reference(m)
            need(np.array_equal(d, d_ref) and np.array_equal(u, u_ref),
                 f"{name} mask {i}: differs from the numpy reference")
            d_pl, u_pl = fused(dg, mt.cuda(), plain=True)
            need(np.array_equal(d, d_pl.cpu().numpy())
                 and np.array_equal(u, u_pl.cpu().numpy()),
                 f"{name} mask {i}: differs from the plain torch path")
            if i == 1 and name == "bench_runs":
                text = depth_op.run_seg_depth(
                    g, dg, [n for n, keep in zip(names, m) if keep]
                )
                need(text == depth_op.seg_depth_table(g, d_ref, u_ref),
                     f"{name}: depth -d -s table differs")
        masks = batch_masks(g.num_paths, rng)
        d, u = depth_op.seg_depth_with_uniq_batch(dg, torch.from_numpy(masks))
        need(d.shape == (32, g.num_segments), f"{name}: batch shape {d.shape}")
        for i, m in enumerate(masks):
            d_ref, u_ref = reference(m)
            need(np.array_equal(d[i], d_ref) and np.array_equal(u[i], u_ref),
                 f"{name} batch row {i}: differs from the numpy reference")
        d_pl, u_pl = depth_op.seg_depth_with_uniq_runs_batch(
            dg, torch.from_numpy(masks).cuda(), plain=True
        )
        need(np.array_equal(d, d_pl.cpu().numpy())
             and np.array_equal(u, u_pl.cpu().numpy()),
             f"{name}: batch differs from the plain torch path")
        after = launch_counts()
        moved = {k: after[k] - before[k] for k in after}
        key = "seg_scan" if route == "scan" else "run_scan"
        need(moved[key] >= 8 and moved["run_scan"] >= 32
             and moved["boundary"] >= 40, f"{name}: launches {moved}")
        print(f"{name}: 8 masks ({route}) and a Q=32 batch (runs) equal numpy "
              f"reference and plain torch; launches {moved}", flush=True)
        out[name] = (g, dg, route)
    return out


def phase_scan_timing(scan: dict, errs: Errors, card: str) -> dict:
    """Phase 3 (scan timing): one routed query and the runs batch at
    Q = 1 and 32, kernels against plain (CUDA-event wall, profiler
    busy); returns K6-K8's kernel timings for the JSON line."""
    import numpy as np
    import torch

    from pollen_tpu_torch.kernels import gatherb, runscan, segscan
    from pollen_tpu_torch.ops import depth as depth_op
    from pollen_tpu_torch.probes.timing import replay_us

    rng = np.random.default_rng(3)
    for name, (g, dg, route) in scan.items():
        m = torch.from_numpy(rng.random(g.num_paths) < 0.5).cuda()
        fused = (depth_op.seg_depth_with_uniq_fused if route == "scan"
                 else depth_op.seg_depth_with_uniq_runs_fused)
        for label, fn in (
            (f"query ({route})", functools.partial(fused, dg, m)),
            (f"query ({route}) plain", functools.partial(fused, dg, m, plain=True)),
        ):
            wall = cuda_ms(fn) * 1e3
            prof = device_profile(fn, reps=10)
            busy = sum(prof.values())
            idle = f"{1 - busy / wall:.3f}" if busy else "not measured"
            print(f"{name} {label} [{card}]: wall {wall:.2f} us "
                  f"({g.num_steps / (wall * 1e-6) / 1e9:.2f} G steps/s), "
                  f"idle share {idle}; {describe_profile(prof)}", flush=True)
        masks = torch.from_numpy(batch_masks(g.num_paths, rng)).cuda()
        for q in (1, 32):
            for plain in (False, True):
                fn = functools.partial(depth_op.seg_depth_with_uniq_runs_batch,
                                       dg, masks[:q], plain=plain)
                wall = cuda_ms(fn, reps=10, warm=2) * 1e3
                busy = sum(device_profile(fn, reps=3).values())
                idle = f"{1 - busy / wall:.3f}" if busy else "not measured"
                print(f"batch {name} Q={q} (runs){' plain' if plain else ''} "
                      f"[{card}]: wall {wall:.2f} us ({wall / q:.2f} us/query, "
                      f"{q * g.num_steps / (wall * 1e-6) / 1e9:.2f} G steps/s), "
                      f"busy {busy:.2f} us, idle share {idle}", flush=True)

    times = {}
    _, dgw, _ = scan["wide_p2e17"]
    mw = torch.from_numpy(rng.random(dgw.num_paths) < 0.5).cuda()
    path, rs = dgw.step_path_sorted, dgw.run_start
    n = path.shape[0]
    # The one-call form of K6 and K8: two int32 cumsums in one call.
    ones = torch.ones((2, n), dtype=torch.int32, device="cuda")
    k6 = functools.partial(segscan.masked_depth_cumsums, path, rs, mw)
    prof = device_profile(k6, reps=5)
    print(f"seg_scan (K6) call at wide_p2e17: {describe_profile(prof)}",
          flush=True)
    need(not prof or ("scan_single" in prof and not any(
        k in prof for k in ("scan_reduce", "scan_totals", "scan_down"))),
         f"K6 is not one single-pass launch: {sorted(prof)}")
    times["seg_scan (K6)"] = (
        k6,
        lambda: segscan.masked_depth_cumsums_plain(path, rs, mw),
        f"wide_p2e17, {n} padded steps",
        bound(16 * n + dgw.num_paths, core_ops=6 * n),
        lambda: torch.cumsum(ones, 1, dtype=torch.int32),
    )
    csums = segscan.masked_depth_cumsums(path, rs, mw)
    nb = dgw.seg_bounds.shape[0]
    times["boundary (K7)"] = (
        lambda: gatherb.gather_boundary_diff(csums, dgw.seg_bounds),
        lambda: gatherb.gather_boundary_diff_plain(csums, dgw.seg_bounds),
        f"wide_p2e17, {nb - 1} segments, two cumsums",
        bound(4 * nb + 2 * 4 * nb + 2 * 4 * (nb - 1), core_ops=4 * (nb - 1)),
        None,
    )
    # K8 at bench_runs (one wave of partitions) and at wide_p2e17's run
    # index (HBM scale); its call must be the single pass, and two 1-D
    # cumsums of the same length are timed beside it.
    for key, cell in (("run_scan (K8)", "bench_runs"),
                      ("run_scan (K8), wide_p2e17", "wide_p2e17")):
        _, dgr, _ = scan[cell]
        mr = torch.from_numpy(rng.random(dgr.num_paths) < 0.5).cuda()
        r = dgr.run_path.shape[0]
        k8 = functools.partial(runscan.masked_run_cumsums, dgr.run_path,
                               dgr.run_count, mr)
        plain = functools.partial(runscan.masked_run_cumsums_plain,
                                  dgr.run_path, dgr.run_count, mr)
        errs.compare(key, k8(), plain(), f"{cell}, a seeded random mask")
        prof = device_profile(k8, reps=10)
        print(f"run_scan (K8) call at {cell}: {describe_profile(prof)}",
              flush=True)
        need(not prof or ("scan_single" in prof and not any(
            k in prof for k in ("scan_reduce", "scan_totals", "scan_down"))),
             f"K8 is not one single-pass launch: {sorted(prof)}")
        ones_r = torch.ones((2, r), dtype=torch.int32, device="cuda")
        one_d = functools.partial(torch.cumsum, ones_r[0], 0,
                                  dtype=torch.int32)
        print(f"two 1-D torch.cumsum calls of {r} int32 at {cell} [{card}]: "
              f"{2 * replay_us(one_d):.2f} us device (graph replay)",
              flush=True)
        times[key] = (
            k8,
            plain,
            f"{cell}, {r} padded runs",
            bound(16 * r + dgr.num_paths, core_ops=4 * r),
            functools.partial(torch.cumsum, ones_r, 1, dtype=torch.int32),
        )
    return time_kernels(times, card)


def probe_matrix(seed, rows=64, cols=8192, complex_every=5):
    """A seeded uint8 nibble matrix with counts 0/1, save every
    ``complex_every``-th 128-column tile, which holds counts up to 15."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = ((rng.random((rows, cols)) < 0.3)
         | ((rng.random((rows, cols)) < 0.3).astype(np.uint8) << 4))
    a = a.astype(np.uint8)
    for t in range(0, cols // 128, complex_every):
        a[:, t * 128:(t + 1) * 128] = rng.integers(0, 256, (rows, 128))
    return a


def compare_probes(errs, cross, m, what):
    """K10-K12 on one matrix and mask against their plain versions; v2
    with its flags all 1, all 0 and from tile_flags."""
    import torch

    from pollen_tpu_torch.kernels import crossprobe as cp

    for mode, name in (("raw", "cross_probe_raw (K10)"),
                       ("vd", "cross_probe_vd (K10)"),
                       ("v1", "cross_probe_v1 (K11)")):
        kernel = getattr(cp, f"cross_probe_{mode}")
        errs.compare(name, kernel(cross, m), cp.cross_probe_plain(cross, m, mode),
                     what)
    n_tiles = cross.shape[1] // cp.TILE
    for label, flags in (
        ("ones", torch.ones(n_tiles, dtype=torch.int32, device="cuda")),
        ("zeros", torch.zeros(n_tiles, dtype=torch.int32, device="cuda")),
        ("tile_flags", cp.tile_flags(cross, cp.TILE)),
    ):
        errs.compare("cross_probe_v2 (K12)", cp.cross_probe_v2(cross, m, flags),
                     cp.cross_probe_plain(cross, m, "v2", flags),
                     f"{what} flags {label}")


def phase_kernels_flat_probes(errs: Errors):
    """Phase 1 (K9-K12): the flat ELL kernel on build_ell of every
    fixture's runs (planned K and K = 1, 2, 4, 16) and on path ids up to
    65535; the probe ladder on every fixture's nibble matrix and on a
    seeded 64 x 8192 matrix where only some tiles hold counts >= 2."""
    import numpy as np
    import torch

    from pollen_tpu_torch import parse_gfa_file
    from pollen_tpu_torch.device import _nibble_pack, build_graph
    from pollen_tpu_torch.kernels import crossmat as cm
    from pollen_tpu_torch.kernels import ellscan as ell

    rng = np.random.default_rng(9)
    for path in sorted((REPO / "tests" / "graphs").glob("*.gfa")):
        g = parse_gfa_file(str(path))
        runs = NumpyReference(build_graph(g, "cuda"))  # real runs only
        run_path, run_count = runs.run_path, runs.run_count
        run_seg = runs.run_seg.astype(np.int32)
        masks = [torch.from_numpy(rng.random(g.num_paths) < 0.5).cuda()
                 for _ in range(4)]
        for k in (None, 1, 2, 4, 16):
            flat, _ = ell.build_ell(run_path, run_count, run_seg,
                                    g.num_segments, k=k)
            flat = torch.from_numpy(flat).cuda()
            for m in masks:
                errs.compare("ell_flat (K9)", ell.masked_ell_depth(flat, m),
                             ell.masked_ell_depth_plain(flat, m),
                             f"{path.name} flat ELL k={k}")
        p_pad = -(-g.num_paths // 128) * 128
        n_pad = -(-g.num_segments // 128) * 128
        a4 = torch.from_numpy(_nibble_pack(
            run_path, run_seg, np.minimum(run_count, cm.CLIP_NIBBLE), p_pad,
            n_pad)).cuda()
        for m in masks:
            compare_probes(errs, a4, m, f"{path.name} nibble matrix")
    # Path ids >= 2^15 set the slot word's sign bit (65536-path masks:
    # 2048 mask words, all staged in shared memory).
    flat, heavy = ell.build_ell(
        np.array([5, 32768, 40000, 65535], np.int32),
        np.array([3, 7, 2, 1], np.int32), np.array([0, 0, 1, 2], np.int32),
        num_segments=128, k=2,
    )
    need(heavy.size == 0, "high path ids: no segment should be heavy")
    flat = torch.from_numpy(flat).cuda()
    for _ in range(4):
        m = rng.integers(0, 2, 65536).astype(np.int32)
        m[[5, 32768, 40000, 65535]] = rng.integers(0, 2, 4)
        mt = torch.from_numpy(m).cuda()
        d, u = ell.masked_ell_depth(flat, mt)
        errs.compare("ell_flat (K9)", (d, u), ell.masked_ell_depth_plain(flat, mt),
                     "path ids 5, 32768, 40000, 65535")
        want = [3 * m[5] + 7 * m[32768], 2 * m[40000], m[65535]]
        need(d[:3].tolist() == want, f"high path ids: depth {d[:3].tolist()}, "
             f"want {want}")
    a = torch.from_numpy(probe_matrix(10)).cuda()
    for _ in range(4):
        compare_probes(errs, a, torch.from_numpy(rng.random(128) < 0.5).cuda(),
                       "seeded 64 x 8192, every 5th tile complex")
    torch.cuda.synchronize()
    print("phase 1 (K9-K12): the flat ELL kernel equals plain on 8 fixtures "
          "(build_ell with the planned K and K = 1, 2, 4, 16) and on path "
          "ids 5, 32768, 40000, 65535; the probe ladder (raw, vd, v1, v2 "
          "with flags all 1, all 0 and from tile_flags) equals plain on "
          "the fixtures' nibble matrices and a seeded 64 x 8192 matrix; "
          "4 masks each (tolerance 0: exact int32)", flush=True)


def phase_flat_ell(graphs: dict) -> dict:
    """The flat-ELL path: build_ell on the real runs of bench and
    chr8_third, then masked_ell_depth (K9) under 8 masks each, against
    plain torch on the card, a numpy sum over the runs (heavy columns
    0) and, on the light segments, the routed query. Returns {name:
    (flat slots on the card, heavy segment ids, graph)}."""
    import numpy as np
    import torch

    from pollen_tpu_torch.kernels import ellscan as ell
    from pollen_tpu_torch.ops import depth as depth_op

    rng = np.random.default_rng(12)
    out = {}
    for name in ("bench", "chr8_third"):
        g, dg, reference = graphs[name]  # its run arrays: real runs only
        t0 = time.perf_counter()
        flat, heavy = ell.build_ell(reference.run_path, reference.run_count,
                                    reference.run_seg.astype(np.int32),
                                    dg.num_segments)
        build_s = time.perf_counter() - t0
        flat = torch.from_numpy(flat).cuda()
        k, n_pad = flat.shape
        n = dg.num_segments
        light = np.ones(n, bool)
        light[heavy] = False
        print(f"{name}: build_ell {build_s:.3f} s: k={k}, {n_pad} columns, "
              f"{heavy.size} heavy segments, {flat.numel() * 4 / 2**20:.2f} "
              "MB of slots", flush=True)
        for i, m in enumerate(scale_masks(g.num_paths, rng)):
            mt = torch.from_numpy(m).cuda()
            d, u = ell.masked_ell_depth(flat, mt)
            d_pl, u_pl = ell.masked_ell_depth_plain(flat, mt)
            need(torch.equal(d, d_pl) and torch.equal(u, u_pl),
                 f"{name} flat mask {i}: differs from plain torch")
            d, u = d.cpu().numpy(), u.cpu().numpy()
            d_ref, u_ref = reference(m)
            d_ref[heavy] = 0
            u_ref[heavy] = 0
            need(np.array_equal(d[:n], d_ref) and np.array_equal(u[:n], u_ref)
                 and not d[n:].any() and not u[n:].any(),
                 f"{name} flat mask {i}: differs from the numpy reference")
            d_rt, u_rt = depth_op.masked_seg_depth(dg, torch.from_numpy(m))
            need(np.array_equal(d[:n][light], d_rt[light])
                 and np.array_equal(u[:n][light], u_rt[light]),
                 f"{name} flat mask {i}: differs from the routed query on "
                 "the light segments")
        print(f"{name}: flat ELL under 8 masks equals plain torch, numpy "
              f"(heavy columns 0) and the routed query on {int(light.sum())} "
              "light segments", flush=True)
        out[name] = (flat, heavy, g)
    return out


def phase_probes(graphs: dict, batch: dict) -> dict:
    """The probe path: crossmat_floor.run and crossmat_variants.run on
    bench_cross's matrix (16 MiB, resident in L2) and on chr8_third's,
    ingested with cross_matrix="always" (256 MiB). Returns {name:
    (matrix, mask, steps)}."""
    import torch

    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.probes import crossmat_floor, crossmat_variants

    g_bench, dg_cross, _ = batch["bench_cross"]
    g8 = graphs["chr8_third"][0]
    t0 = time.perf_counter()
    dg8 = build_graph(g8, "cuda", cross_matrix="always")
    torch.cuda.synchronize()
    print(f"chr8_third with its crossing matrix: ingest "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    out = {}
    for name, g, dg in (("bench_cross", g_bench, dg_cross),
                        ("chr8_third", g8, dg8)):
        cross = dg.cross_matrix
        need(dg.cross_nibble, f"{name}: expected a nibble matrix")
        mask = torch.zeros(2 * cross.shape[0], dtype=torch.int32, device="cuda")
        mask[: dg.num_paths] = 1
        print(f"probes on {name}'s matrix {tuple(cross.shape)} "
              f"({cross.numel() / 2**20:.0f} MiB):", flush=True)
        floor = crossmat_floor.run(cross, mask, n_steps=g.num_steps)
        variants = crossmat_variants.run(cross, mask, n_steps=g.num_steps)
        need(all(r["exact"] for r in floor.values()),
             f"{name}: a floor probe differs from its plain version")
        need(all(r["depth_ok"] and r["uniq_ok"] in (True, "skipped")
                 for k, r in variants.items() if k != "complex_tiles"),
             f"{name}: a variant differs from v0")
        out[name] = (cross, mask, g.num_steps)
    return out


def phase_flat_probe_timing(graphs: dict, flat: dict, probes: dict,
                            errs: Errors, card: str) -> dict:
    """K9 against K3 on the same slots at chr8_third (flat against
    tall) at the planned K and at K = 2 and 4, then K9-K12 against
    their plain versions and library calls (K10-K12 at both matrices,
    first held against plain under a seeded random mask; the JSON line
    keeps chr8_third's)."""
    import numpy as np
    import torch

    from pollen_tpu_torch.kernels import crossmat as cm
    from pollen_tpu_torch.kernels import crossprobe as cp
    from pollen_tpu_torch.kernels import ellscan as ell
    from pollen_tpu_torch.probes.timing import replay_us

    rng = np.random.default_rng(4)
    slots, _, g8 = flat["chr8_third"]
    _, dg8, reference = graphs["chr8_third"]
    m = torch.from_numpy(rng.random(g8.num_paths) < 0.5).cuda()
    planned_k = slots.shape[0]
    # At K = 1 the tall packing holds the flat array's bytes in the same
    # order, so only K = 2 and 4 compare two layouts.
    for k in (planned_k, 2, 4):
        if k == planned_k:
            ks = slots
        else:
            ks, _ = ell.build_ell(reference.run_path, reference.run_count,
                                  reference.run_seg.astype(np.int32),
                                  dg8.num_segments, k=k)
            ks = torch.from_numpy(ks).cuda()
        n_pad = ks.shape[1]
        tall = torch.from_numpy(ell.pack_ell_tall(ks.cpu().numpy())).cuda()
        d_f, u_f = ell.masked_ell_depth(ks, m)
        d_t, u_t = ell.masked_ell_depth_tall(tall, m, k)
        d_p, u_p = ell.masked_ell_depth_plain(ks, m)
        need(torch.equal(d_f, d_t[:n_pad]) and torch.equal(u_f, u_t[:n_pad])
             and torch.equal(d_f, d_p) and torch.equal(u_f, u_p),
             f"chr8_third k={k}: flat, tall and plain disagree")
        flat_fn = functools.partial(ell.masked_ell_depth, ks, m)
        tall_fn = functools.partial(ell.masked_ell_depth_tall, tall, m, k)
        walls = [cuda_ms(f) * 1e3 for f in (flat_fn, tall_fn, tall_fn, flat_fn)]
        devs = [replay_us(f) for f in (flat_fn, tall_fn, tall_fn, flat_fn)]
        layout = "same layout" if k == 1 else "two layouts"
        print(f"flat vs tall at chr8_third, k={k} ({layout}), {n_pad} columns, "
              f"32-bit slots [{card}]: K9 flat {min(devs[0], devs[3]):.2f} us "
              f"device, {min(walls[0], walls[3]):.2f} us wall; K3 tall "
              f"{min(devs[1], devs[2]):.2f} us device, {min(walls[1], walls[2]):.2f}"
              f" us wall (runs flat, tall, tall, flat: device "
              f"{' '.join(f'{x:.2f}' for x in devs)} us; wall "
              f"{' '.join(f'{x:.2f}' for x in walls)} us)", flush=True)
        del tall
    k, n_pad = slots.shape
    flat_call = functools.partial(ell.masked_ell_depth, slots, m)
    times = {"ell_flat (K9)": (
        flat_call,
        functools.partial(ell.masked_ell_depth_plain, slots, m),
        f"chr8_third flat ELL k={k}, {n_pad} columns",
        bound(4 * k * n_pad + 8 * n_pad + g8.num_paths, core_ops=4 * k * n_pad),
        ell_library("ell_flat (K9)", flat_call, m, g8.num_paths, flat=slots),
    )}
    out = time_kernels(times, card)

    for name in ("bench_cross", "chr8_third"):
        cross, mask, _ = probes[name]
        rows, n = cross.shape
        # The probe path ran under the all-ones mask: a seeded random one
        # exercises the row skip and the folding at full size.
        m_rand = torch.from_numpy(rng.random(mask.numel()) < 0.5).cuda()
        compare_probes(errs, cross, m_rand & (mask != 0),
                       f"{name} matrix, a seeded random mask")
        flags = cp.tile_flags(cross, cp.TILE)
        mp = cm.pad_mask(mask, 2 * rows)
        # The library calls: float32 products of the (folded) mask and a
        # copy of A made ahead of time (raw: the even paths against the
        # bytes as they are; the rest: the unpacked nibbles), depth only.
        even, raw_f = mp[0::2].float()[None], cross.float()
        fm, a_f = cm.fold_mask(mp).float()[None], cm.unpack_cross(cross).float()
        where = f"{name} matrix {tuple(cross.shape)}"
        io = rows * n + 2 * rows + 8 * n
        times = {
            "cross_probe_raw (K10)": (
                functools.partial(cp.cross_probe_raw, cross, mask),
                functools.partial(cp.cross_probe_plain, cross, mask, "raw"),
                where, bound(io, tensor_ops=2 * rows * n),
                lambda: torch.matmul(even, raw_f),
            ),
            "cross_probe_vd (K10)": (
                functools.partial(cp.cross_probe_vd, cross, mask),
                functools.partial(cp.cross_probe_plain, cross, mask, "vd"),
                where, bound(io, tensor_ops=2 * 2 * rows * n),
                lambda: torch.matmul(fm, a_f),
            ),
            "cross_probe_v1 (K11)": (
                functools.partial(cp.cross_probe_v1, cross, mask),
                functools.partial(cp.cross_probe_plain, cross, mask, "v1"),
                where, bound(io, tensor_ops=4 * 2 * rows * n),
                lambda: torch.matmul(fm, a_f),
            ),
            "cross_probe_v2 (K12)": (
                functools.partial(cp.cross_probe_v2, cross, mask, flags),
                functools.partial(cp.cross_probe_plain, cross, mask, "v2", flags),
                f"{where}, {int(flags.sum())}/{flags.numel()} tiles flagged",
                bound(io + 4 * flags.numel(), tensor_ops=4 * 2 * rows * n),
                lambda: torch.matmul(fm, a_f),
            ),
        }
        out.update(time_kernels(times, card))  # chr8_third's rows stay
        del raw_f, a_f
        torch.cuda.empty_cache()
    out.update(time_cross_chr8(probes, errs, card, rng))
    return out


def time_cross_chr8(probes: dict, errs: Errors, card: str, rng) -> dict:
    """K2 on chr8_third's 256 MiB nibble matrix: held against plain under
    a seeded random mask and under the all-ones mask, then timed under
    the mask of every path the graph has, against its library call, the
    float32 product of the folded mask by [A | min(A, 1)] (4 GiB of
    float32 made ahead of time), or where the card lacks the memory,
    by the unpacked A alone (depth only, the vd rung's form). The bound
    counts the byte rows that mask selects (a row whose two paths are
    both out of the mask is never needed), the mask and the outputs."""
    import torch

    from pollen_tpu_torch.kernels import crossmat as cm

    cross, mask, _ = probes["chr8_third"]
    rows, n = cross.shape
    name = "cross (K2), chr8_third matrix"
    mp = cm.pad_mask(mask, 2 * rows)
    m_rand = torch.from_numpy(rng.random(2 * rows) < 0.5).cuda() & (mp != 0)
    for m, what in ((m_rand, "a seeded random mask"), (mp, "the all-ones mask")):
        errs.compare(name, cm.masked_cross_depth(cross, m, nibble=True),
                     cm.masked_cross_depth_plain(cross, cm.pad_mask(m, 2 * rows),
                                                 nibble=True),
                     f"chr8_third matrix {tuple(cross.shape)}, {what}")
    fm = cm.fold_mask(mp).float()[None]
    live = int(((mp[0::2] != 0) | (mp[1::2] != 0)).sum())  # rows needed
    print(f"{name}: the mask selects {int((mp != 0).sum())} paths, "
          f"{live} of {rows} byte rows", flush=True)
    free, _ = torch.cuda.mem_get_info()
    if free > 6 * (2 * rows) * n * 4 + 2**30:  # the copies made on the way
        a_lib = both_products(cm.unpack_cross(cross)).float()
        form = "float32 torch.matmul, folded mask x [A | min(A, 1)]"
    else:
        a_lib = cm.unpack_cross(cross).float()
        form = ("float32 torch.matmul, folded mask x A (depth only: "
                f"{free / 2**30:.1f} GiB free)")
    torch.cuda.empty_cache()
    print(f"{name}: library call {form}", flush=True)
    times = {name: (
        functools.partial(cm.masked_cross_depth, cross, mp, nibble=True),
        functools.partial(cm.masked_cross_depth_plain, cross, mp, nibble=True),
        f"chr8_third matrix {tuple(cross.shape)}, all-ones mask",
        bound(live * n + 2 * rows + 8 * n, tensor_ops=4 * 2 * live * n),
        lambda: torch.matmul(fm, a_lib),
    )}
    out = time_kernels(times, card)
    del a_lib
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not (REPO / "pollen_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(pollen_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    from pollen_tpu_torch.kernels import _build

    t0 = time.perf_counter()

    def stamp(what):
        print(f"[{time.perf_counter() - t0:.1f} s] {what}", flush=True)

    _build.load()
    stamp(f"built {_build.library_path().name}")
    for line in _build.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip().split("ptxas info    : ")[-1])
    check_sass(_build.library_path())

    errs = Errors()
    phase_kernels(errs)
    phase_kernels_split(errs)
    phase_kernels_cross_batch(errs)
    phase_kernels_cross(errs)
    phase_kernels_scan(errs)
    phase_kernels_flat_probes(errs)
    stamp("phase 1 done")
    graphs: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        # Each main path runs with the counts set to 0 just before it
        # and read just after: the single query, then the batch.
        reset_launches()
        phase_goldens(pathlib.Path(tmp))
        phase_scale(graphs)
        single = launch_counts()
        stamp("single-query main path done")
        reset_launches()
        phase_goldens_batch(pathlib.Path(tmp))
        batch = phase_scale_batch(graphs)
        batched = launch_counts()
        stamp("batch main path done")
        reset_launches()
        phase_goldens_scan(pathlib.Path(tmp))
        scan = phase_scale_scan()
        scanned = launch_counts()
        stamp("scan-family main path done")
    reset_launches()
    flat = phase_flat_ell(graphs)
    flat_counts = launch_counts()
    stamp("flat-ELL path done")
    reset_launches()
    probes = phase_probes(graphs, batch)
    probe_counts = launch_counts()
    stamp("probe path done")
    print(f"main-path launches: single query {single}; batch {batched}; "
          f"scan family {scanned}; flat ELL {flat_counts}; probes "
          f"{probe_counts}", flush=True)
    launches = {}
    for names, counts in ((SINGLE_PATH, single), (BATCH_PATH, batched),
                          (SCAN_PATH, scanned), (FLAT_PATH, flat_counts),
                          (PROBE_PATH, probe_counts)):
        for name in names:
            launches[name] = counts[KERNELS[name][2]]
            need(launches[name] > 0,
                 f"{name} was never launched by its main path")

    timing = phase_timing(graphs, batch, errs, card)
    stamp("single-query and kernel timing done")
    phase_batch_timing(batch, card)
    stamp("batch timing done")
    timing.update(phase_scan_timing(scan, errs, card))
    stamp("scan-family timing done")
    timing.update(phase_flat_probe_timing(graphs, flat, probes, errs,
                                         card))
    stamp("flat-ELL and probe timing done")
    rows = [
        dict(name=name, route="cuda", source=src, replaces=replaces,
             launches=launches[name], max_abs_err=errs.max[name],
             **timing[name])
        for name, (src, replaces, _) in KERNELS.items()
    ]
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
