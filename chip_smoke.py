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
   slots (4 seeded masks each; and at 1 to 17 stored words a column on
   3 row groups, path ids up to 65535, under 65,536-path, 300-path and
   all-ones masks, one launch a call and no packing launch); the
   batched split ELL K4 on 1-3 tiers, with and without a heavy block,
   and the batched crossing matrix K5
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
and a head carry (a host int, and an int32 on the device), and K6's
single pass at 2^25 steps (one group; a group start every 7 steps,
each under both carries; 20 back-to-back calls; two replays of a
captured CUDA graph), and K8's at 2^25 runs (all-ones mask, the
weighted sum wrapping past 2^31; seeded runs; 20 back-to-back calls;
two graph replays) (phase 1); ``depth -d -s`` (route "scan") and
``depth -d -S`` (route "runs") goldens and a ``serve`` request of each
under POLLEN_CROSS_BUDGET_MB=0 (phase 2); and two synthetic graphs,
wide_p2e17 (2^17 paths, route "scan") and bench_runs (route "runs"),
8 masks and a Q = 32 batch each, against plain and numpy (phase 3).

The flat single-tier ELL (K9) and the crossing-matrix probe ladder
(K10 raw and vd, K11, K12) are checked against their plain versions on
the fixtures, on path ids up to 65535 and on seeded matrices where only
some tiles hold counts >= 2 (64 x 8192; 64 x 8320, a narrower last v2
tile; 2,500 byte rows, past the row-list chunk), each probe call one
launch (phase 1). Two more paths follow: the flat
ELL path (``build_ell`` on the real runs of bench and chr8_third, then
``masked_ell_depth`` under 8 masks, against plain, numpy and the routed
query) and the probe path (the two probe scripts' ``run`` on bench's
16 MiB crossing matrix and chr8_third's 256 MiB one). K9 is timed
against K3 on the same slots (flat against tall), and the probe ladder
at both matrices and at the unfused heavy block, each rung's bound
counting only the byte rows its mask selects.

The graph commands beyond depth have no kernel of their own (plain
torch on the card). Phase 2 runs each through ``fgfa-torch --device
cuda`` on the 8 fixtures: ``degree``, ``flatten``, ``overlap``,
``validate`` (and on ``*.validate_setup``), ``matrix-adj``, ``paths``,
``norm``, ``crush``, ``flip``, ``chop -c 3`` and the GFA round trip
byte for byte against the goldens; ``depth -b``, ``window-depth``,
``bed-depth``, ``position``, ``stats``, ``toc`` and ``-O`` against
the port's ``--device cpu`` answer; ``-o`` against
``tiny.flatgfa.hex``; and one ``serve`` stream mixing them with depth
requests. A scale phase adds links to chr8_third (the unique adjacent
handle pairs of its paths, a seeded 1 in 10^4 dropped), holds each
device op (``seg_degree``, ``step_intervals``, ``_unsupported_pairs``,
``positions_in_path`` at 4,096 offsets, ``_touch_matrix``,
``_reverse_heavy_paths``, ``interval_depth`` at 1,000 bp windows) on
cuda against the same function on a CPU copy and a numpy formula,
exact (``positions_in_path`` also given numpy offsets, equal to its
tensor-input answer), and times each (CUDA-event wall, CUDA-graph
replay where the op allows capture, profiler busy time, idle share,
byte bound); then times
CLI runs end to end over ``-i chr8.flatgfa`` (written by ``-o``):
``degree``, ``validate``, ``position``, ``window-depth``, ``overlap``;
``flip`` and ``flatten`` at bench with links, where their text takes
seconds. Its rows are the ``{"device_ops": [...]}`` line, printed
before the kernels' line.

The rest of the CLI has no kernel either. Phase 2 runs ``inject``
(against the ``*.inject`` goldens), ``gaf`` (``-s``, ``-b``, ``-p``),
``matrix``, ``pangenotype`` and ``extract`` (and its ``-o``) on the 8
fixtures and examples/example.gfa with seeded read sets (and
example.gaf) against ``--device cpu``, the ``seq-export`` /
``seq-import`` round trip against tiny.packedseq.hex, ``bench --wcl
[-p]`` against a newline count, ``exine-torch depth -a -r`` against the
depth goldens, and one serve stream of them. Its scale phase holds
``chunk_reads`` over a seeded GAF of 2^20 reads of chr8_third (1-31
steps each) and ``node_depth_accel`` at 2^16 nodes against a CPU copy
and a numpy formula, exact (each, and ``node_depth_accel_simple``, also
given numpy inputs beside a cuda tensor, equal to its tensor-input
answer), times each as the graph commands' ops
(their rows join the ``device_ops`` line), and times ``gaf -b`` (split
into load, ingest, parse and chunk), ``gaf``, ``pangenotype``,
``bench --wcl``, ``seq-*``, ``inject`` and ``extract`` end to end.

The library surfaces run last (phase 4), at chr8_third on the card:
the object API (``save_flatgfa``, ``pollen_tpu_torch.load``, spot
checks, ``g.device()``'s ingest under ``profiling.stopwatch``, the
routed query, route "ell" and fused K1, under three seeded masks
against numpy's bincount and phase 3's index, timed by
``profiling.time_best`` and ``cuda_ms``, traced by
``profiling.device_trace``; ``g.all_reads`` over the 2^20-read GAF,
its first 10,000 ``GAFLine``s against ``numpy_chunker``), a
three-command ``flash-torch -O`` script (``odgi depth -d``, path
length into 100 kb windows, interval depth over them) through the
console script on cuda and on the CPU, the same bytes, its ``-d``
table that of ``fgfa-torch depth -d``, and ``entry("cuda")`` (its
forward, then the routed query on its graph: route "cross", K2). Its
numbers are the ``{"api_shell": ...}`` line.

Phase 5 adds the native host code, the spec oracle, the permuted ELL
query and the two newer probes. The native library
(``pollen_tpu_torch/native``) must build with ``POLLEN_NATIVE`` unset
(no hidden fallback; a failed build fails the phase with the
compiler's message). On the 8 fixtures its parse equals the NumPy
parser's field by field under ``POLLEN_SCAN_THREADS`` = 1 and the
default, its emit (to a string and a file) the NumPy emit and the
input, its converter parse + ``save_flatgfa``; the C API's
``example.c``, built against the port's copies, passes
tests/test_capi.py's assertions. bench and chr8_third with links are
written as GFA text (seeded ACGT bases); the parse (native against NumPy
at bench), the emit to a string and to a file (at bench) and the
conversion (``convert_gfa_native`` and ``fgfa-torch --device cuda -I
-o`` end to end) are timed with the text's bytes and MB/s, each pair
equal. The spec oracle: ``fgfa-torch --device cuda`` runs ``depth -d``,
``depth -d -s``, ``degree``, ``matrix-adj``, ``flatten``, ``overlap``,
``validate``, ``crush``, ``flip``, ``chop -c 1`` and ``-c 4`` on seeded
``tests/graphgen.py`` graphs (tests/test_random_parity.py's seeds 11-13
and two larger), each byte for byte against
``pollen_tpu_torch.spec.commands``, and ``pollen-spec-torch``
reproduces the fixtures' goldens. ``seg_depth_with_uniq_ell_permuted``
runs as a path of its own on bench, chr8_third and unfused under 8
masks each (launch counts reset before each graph: K1, or K3 and K2),
equal to the kernels' parts composed on the host, and un-permuted to
the plain path and numpy; one call is timed against the host-composed
``seg_depth_with_uniq_ell``. Then ``ell_probe``'s ``ellok``,
``ellbok`` and ``ellp16ok`` report diff 0 at bench and on a heavy-free
graph, ``ellp16`` times pack16 there, ``ellcal`` gives the K3 and K2
calibration points and fits, and ``ellraw``, ``scanb``, ``runsk``,
``scatter`` and ``transform_probe``'s ``chop`` and ``crush`` run at
bench. K1-K4 and K6-K8 must be launched by this phase. Its numbers are
the ``{"native_spec_probes": ...}`` line.

Phase 6 drives the sharded path (``pollen_tpu_torch/parallel/``) two
ways. First as one rank over NCCL in this process (a 1 x 1 mesh): on
the 8 fixtures under two masks each, the cumsum, scatter and fused
(K6) scan forms, the column-sharded crossing matrix (K2) and tiered
ELL (K9; its batch) and the degree equal the single-device ``--device
cuda`` answers; ``distributed.ingest_arena`` and ``ingest`` equal the
parse and ``build_graph``'s chunk; the fused query runs whole under
``torch.cuda.set_sync_debug_mode("error")`` (no host sync between its
all-gather and K6, whose head carry it reads from the device). Then as
two ranks sharing the one card over gloo (NCCL refuses two ranks on one
device), spawned with a deadline, at full size: wide_p2e17's fused
query on K6 (the chunk bound straddled by a group), the cumsum and the
scatter forms under 8 masks; chr8_third's sharded ELL (three tiers and
heavy: K9 once for the three tiers, K2) under 8 masks and its batch at
Q = 32 (plain batched
tiers, K5 on the heavy slice); chr8_third's crossing matrix (256 MiB,
K2) under 8 masks; bench's degree; and ``ingest_arena`` over bench's
GFA text (38 MB), each rank parsing its own byte range, equal to the
single-process parse field by field. Every answer is gathered and
held, exactly, against the single-device routed query on the same rank
and ``NumpyReference``. Each sharded query's wall and busy time are
printed per rank beside the single-device routed query's ("2 ranks on
one H100": two ranks sharing a card, not a scaling result), with the
batched tiers' plain time and the exchange's seconds; rank 1 then
times K6 (device carry), K9 (its tier-1 slice, and its three tier slices
in one launch), K2 and K5 on its own piece, their rows of the kernels'
line. Its numbers are the ``{"sharded": ...}`` line.

Phase 7 runs the port's examples (``examples/torch/``), the
counterparts of ``examples/``. Each of the seven runs as a subprocess
on its fixtures (all started at once) with ``--device cuda`` and with
``--device cpu``: the two stdouts must be the same bytes and carry the
lines tests/test_examples.py expects (spec_depth.py has no device and
runs once). Then ``batch_depth.py``'s ``main`` runs in this process on
bench (with its paths' links, as GFA text) on the card, stdout to a
file, with the launch counts set to 0 before it and every plain
version made to raise: its three subset tables must equal
``NumpyReference`` under the numpy masks it built, K4 must have run,
and its seconds end to end (parse, ingest, first query, text) and its
query's CUDA-event wall per call are printed. Last, ``depth.py``'s
``main`` walks unfused (2^20 steps, as GFA text) through the object
API, checks the walk against ``seg_depth_with_uniq`` on the card, and
its table is held against ``NumpyReference``; the walk's seconds are
printed. Its numbers are the ``{"examples": ...}`` line.

Launch counts are set to 0 right before each main path (the single
query: phase 2's single-query requests and phase 3's queries; the
batch: phase 2's ``-S`` requests and phase 3's batches; the scan
family: its phase 2 requests and phase 3 queries and batches; the flat
ELL path; the probe path; phase 4's API queries, K1, and its entry,
K2; phase 5's permuted query on each graph, and its probes; phase 6's
sharded queries, on each rank; phase 7's batch example) and read right after it: every kernel
must have been launched by its path (phase 6: K6 by the fused query,
K9 and K2 by the ELL query, K9 exactly once a query on every rank and
in the one-rank run, K5 by its batch, K2 by the crossing matrix's; phase
7's batch example, K4). Each kernel's time is its CUDA-event
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
import logging
import os
import pathlib
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

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
# The sharded path (phase 6): four kernels timed again on the timed
# rank's own piece of the graph (two ranks sharing the card); their
# launches are phase 6's sharded queries' counts.
SHARDED_ROWS = (
    "seg_scan (K6), sharded fused, device carry",
    "ell_flat (K9), sharded ELL tier 1",
    "ell_flat (K9), sharded ELL tiers 1-3, one launch",
    "cross (K2), sharded crossing matrix",
    "cross_batch (K5), sharded ELL heavy, Q=32",
)
KERNELS.update(zip(SHARDED_ROWS, (
    (SRC_SCAN, "pollen_tpu/kernels/segscan.py:129", "seg_scan"),
    (SRC, "pollen_tpu/kernels/ellscan.py:326", "ell_flat"),
    (SRC, "pollen_tpu/kernels/ellscan.py:326", "ell_flat"),
    (SRC, "pollen_tpu/kernels/crossmat.py:102", "cross"),
    (SRC_BATCH, "pollen_tpu/kernels/crossmat.py:290", "cross_batch"),
)))
# The ladder timed a second time at the unfused heavy block, where K2
# loses to the float32 matmul (the same kernels and launch counts).
UNFUSED_PROBES = ", unfused heavy block"
KERNELS.update({
    f"{name}{UNFUSED_PROBES}": KERNELS[name]
    for name in ("cross_probe_raw (K10)", "cross_probe_vd (K10)",
                 "cross_probe_v1 (K11)", "cross_probe_v2 (K12)")
})
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
PROBE_PATH = tuple(name for name in KERNELS if "cross_probe" in name)
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
    operations over their peaks (``pollen_tpu_torch/probes/timing.py``)."""
    from pollen_tpu_torch.probes.timing import (
        CUDA_CORE_OPS, HBM_BPS, INT8_TENSOR_OPS)

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
    from pollen_tpu_torch.device import _nibble_pack, build_graph, ell_tiers
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
                tiers = ell_tiers(dg)
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
                tiers = ell_tiers(dg)
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


# K3's edges: stored words a column across tier_tile's chunks of 1, 2,
# 4 and 8 words; path ids whose bits sit in the first, middle and last
# mask words, two with the slot word's sign bit set.
TIER_KS = (1, 2, 3, 4, 5, 8, 9, 17)
TIER_IDS = (5, 32768, 40000, 65535)


def one_launch(errs: Errors, name, call, plain, key, counters, what):
    """Hold ``call`` against ``plain`` and check that it added exactly one
    to its wrapper's launch count ``key``."""
    before = counters[key]
    got = call()
    need(counters[key] == before + 1,
         f"{name} {what}: {counters[key] - before} launches, want 1")
    errs.compare(name, got, plain(), what)


def phase_kernels_tier(errs: Errors):
    """Phase 1 (K3's edges), each call against its plain version,
    tolerance 0: random tall tiers of 3 row groups (odd) at k =
    TIER_KS stored words, read as 32-bit and as pack16 slots (every
    32-bit word is a valid slot in both), with the path ids TIER_IDS
    planted; seeded masks of 65,536 paths (bytes and int32), a mask of
    300 paths and the all-ones mask; one launch a call (the wrapper's
    counter) and, by the profiler, one ell_tier_kernel and nothing else
    (no packing launch); a misaligned tier refused."""
    import numpy as np
    import torch

    from pollen_tpu_torch.kernels import ellscan as ell

    name = "ell_tier (K3)"
    rng = np.random.default_rng(17)
    gen = torch.Generator().manual_seed(17)
    masks = {
        "seeded 65536 int32": torch.from_numpy(
            rng.integers(0, 2, 65536).astype(np.int32)).cuda(),
        "seeded 65536 bytes": torch.from_numpy(rng.random(65536) < 0.5).cuda(),
        "seeded 300": torch.from_numpy(rng.random(300) < 0.5).cuda(),
        "all ones": torch.ones(65536, dtype=torch.int32, device="cuda"),
    }
    ids = torch.tensor(TIER_IDS, dtype=torch.int64)
    g = 3
    for k in TIER_KS:
        tall = torch.randint(-2**31, 2**31, (g * k * ell.SUB, ell.TALL_W),
                             dtype=torch.int64, generator=gen)
        tall[torch.rand(tall.shape, generator=gen) < 0.3] = 0
        tall[0, :4] = ids << 16 | torch.tensor([3, 7, 2, 1])
        tall[-1, -4:] = ids << 16 | torch.tensor([1, 2, 3, 4])
        tall = (tall - ((tall >= 2**31).long() << 32)).to(torch.int32).cuda()
        for p16 in (False, True):
            for label, m in masks.items():
                one_launch(
                    errs, name,
                    functools.partial(ell.masked_ell_depth_tall, tall, m, k, p16),
                    functools.partial(ell.masked_ell_depth_tall_plain, tall, m,
                                      k, p16),
                    "ell_tier", ell.launches,
                    f"k={k}, g={g}, pack16={p16}, {label} mask",
                )
        if k in (2, 17):
            for p16 in (False, True):
                prof = device_profile(functools.partial(
                    ell.masked_ell_depth_tall, tall, masks["all ones"], k, p16),
                    reps=3)
                print(f"{name} call, k={k}, pack16={p16}: "
                      f"{describe_profile(prof)}", flush=True)
                need(not prof or set(prof) == {"ell_tier_kernel"},
                     f"{name} is not one ell_tier_kernel launch: {sorted(prof)}")
    flat = torch.zeros(ell.SUB * ell.TALL_W + 1, dtype=torch.int32, device="cuda")
    try:
        ell.masked_ell_depth_tall(flat[1:].view(ell.SUB, ell.TALL_W),
                                  masks["seeded 300"], 1)
    except ValueError as exc:
        need("16-byte" in str(exc), f"{name}: misaligned tier: {exc}")
    else:
        raise SmokeError(f"{name}: a tier 4 bytes off 16 was not refused")
    torch.cuda.synchronize()
    print(f"phase 1 (K3): k = {', '.join(map(str, TIER_KS))} stored words, "
          f"3 row groups, 32-bit and pack16 slots, path ids "
          f"{', '.join(map(str, TIER_IDS))}, masks of 65536 paths (int32 and "
          "bytes), of 300 paths and all ones: all equal plain (tolerance "
          "0); one launch a call (counter), one ell_tier_kernel and no "
          "packing launch (profiler); a misaligned tier refused", flush=True)


# K9's edges: stored words a column across the tier tile's chunks of 1,
# 2, 4 and 8 words; column counts whose last 1,024-column tile is whole,
# cut to 128 columns, and 128 past 294,912 (the sharded tier-1 slice);
# path ids in the first, middle and last mask words, three with the slot
# word's sign bit set.
FLAT_KS = (1, 2, 3, 5, 9, 16)
FLAT_COLS = (128, 1152, 294912 + 128)
FLAT_IDS = (5, 32767, 32768, 40000, 65535)


def flat_slots(gen, k, n, offset=0):
    """Seeded int32[k, n] flat slots on the card (any 32-bit word is a
    slot), 30% empty, FLAT_IDS planted in the first and the last
    columns; ``offset`` ints into a larger buffer (offset 1: a view 4
    bytes off a 16-byte boundary)."""
    import torch

    v = torch.randint(-2**31, 2**31, (k, n), dtype=torch.int64, generator=gen)
    v[torch.rand(v.shape, generator=gen) < 0.3] = 0
    ids = torch.tensor(FLAT_IDS, dtype=torch.int64)
    v[0, :ids.numel()] = ids << 16 | torch.arange(1, ids.numel() + 1)
    v[-1, -ids.numel():] = ids << 16 | 0xFFFF
    v = (v - ((v >= 2**31).long() << 32)).to(torch.int32)
    buf = torch.empty(k * n + offset, dtype=torch.int32, device="cuda")
    out = buf[offset:].view(k, n)
    out.copy_(v.cuda())
    return out


def phase_kernels_flat(errs: Errors):
    """Phase 1 (K9's edges), each call against its plain version,
    tolerance 0: random flat slots at k = FLAT_KS and FLAT_COLS columns
    with the path ids FLAT_IDS planted; seeded masks of 65,536 paths
    (int32 and bytes), of 300 and of 70,000 paths and the all-ones mask;
    a view 4 bytes off a 16-byte boundary (the 4-byte-load instance);
    2 and 3 tiers in one call, one of them misaligned; one launch a
    call (the wrapper's counter) and, by the profiler, one
    ell_flat_kernel and no packing launch."""
    import numpy as np
    import torch

    from pollen_tpu_torch.kernels import ellscan as ell

    name = "ell_flat (K9)"
    rng = np.random.default_rng(19)
    gen = torch.Generator().manual_seed(19)
    masks = {
        "seeded 65536 int32": torch.from_numpy(
            rng.integers(0, 2, 65536).astype(np.int32)).cuda(),
        "seeded 65536 bytes": torch.from_numpy(rng.random(65536) < 0.5).cuda(),
        "seeded 300": torch.from_numpy(rng.random(300) < 0.5).cuda(),
        "seeded 70000 int32": torch.from_numpy(
            rng.integers(0, 2, 70000).astype(np.int32)).cuda(),
        "all ones": torch.ones(65536, dtype=torch.int32, device="cuda"),
    }

    def check(tiers, what):
        for label, m in masks.items():
            one_launch(
                errs, name,
                functools.partial(ell.masked_ell_depth_tiers, tiers, m),
                lambda: tuple(x for e in tiers
                              for x in ell.masked_ell_depth_plain(e, m)),
                "ell_flat", ell.launches, f"{what}, {label} mask",
            )

    def profile(tiers, what):
        prof = device_profile(functools.partial(
            ell.masked_ell_depth_tiers, tiers, masks["all ones"]), reps=3)
        print(f"{name} call, {what}: {describe_profile(prof)}", flush=True)
        need(not prof or set(prof) == {"ell_flat_kernel"},
             f"{name} is not one ell_flat_kernel launch: {sorted(prof)}")

    for n in FLAT_COLS:
        for k in FLAT_KS:
            e = flat_slots(gen, k, n)
            check([e], f"k={k}, {n} columns")
            if k in (2, 16) and n == FLAT_COLS[-1]:
                profile([e], f"k={k}, {n} columns")
    for k in (1, 5):
        e = flat_slots(gen, k, 1152, offset=1)
        need(e.data_ptr() % 16 == 4, "the misaligned view is not 4 bytes off")
        check([e], f"k={k}, 1152 columns, 4 bytes off 16")
        profile([e], f"k={k}, 1152 columns, 4 bytes off 16")
    for tiers in (
        [flat_slots(gen, 1, FLAT_COLS[-1]), flat_slots(gen, 2, 1152)],
        [flat_slots(gen, 3, 128), flat_slots(gen, 9, 1152),
         flat_slots(gen, 16, FLAT_COLS[-1])],
        [flat_slots(gen, 2, 1152, offset=1), flat_slots(gen, 5, 128),
         flat_slots(gen, 1, FLAT_COLS[-1])],
    ):
        what = (f"{len(tiers)} tiers in one call, (k, columns) "
                f"{[tuple(e.shape) for e in tiers]}, first 4 bytes off 16 "
                f"{tiers[0].data_ptr() % 16 != 0}")
        check(tiers, what)
        profile(tiers, what)
    torch.cuda.synchronize()
    print(f"phase 1 (K9): k = {', '.join(map(str, FLAT_KS))} stored words at "
          f"{', '.join(map(str, FLAT_COLS))} columns, path ids "
          f"{', '.join(map(str, FLAT_IDS))}, masks of 65536 paths (int32 and "
          "bytes), of 300 and 70000 paths and all ones; views 4 bytes off "
          "16; 2 and 3 tiers a call: all equal plain (tolerance 0); one "
          "launch a call (counter), one ell_flat_kernel and no packing "
          "launch (profiler)", flush=True)


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
        hc_dev = torch.tensor(hc, dtype=torch.int32, device="cuda")
        for _ in range(4):
            mk = (rng.random(8) < 0.5).astype(np.int32)
            mk[3] = 1
            seg(cuda(ids), cuda(rs), None, cuda(mk), f"head carry {hc}", hc)
            # The carry as an int32 on the device (the sharded query's):
            # against plain with the same tensor, and the int carry.
            seg(cuda(ids), cuda(rs), None, cuda(mk),
                f"head carry {hc} on the device", hc_dev)
            errs.compare("seg_scan (K6)",
                         segscan.masked_depth_cumsums(cuda(ids), cuda(rs),
                                                      cuda(mk), hc_dev),
                         segscan.masked_depth_cumsums(cuda(ids), cuda(rs),
                                                      cuda(mk), hc),
                         f"head carry {hc}: device against int")
    check_seg_scan_lookback(errs)
    check_run_scan_lookback(errs)
    torch.cuda.synchronize()
    print("phase 1 (scan family): K6, K7, K8 equal their plain versions on "
          f"8 fixtures and P = {', '.join(map(str, SCAN_PS))} (1-3 scan "
          "blocks), a group across three blocks and of 2^23 steps, head "
          "carry 0-2 (a host int, and an int32 on the device equal to the "
          "int's answer); 4 masks each; K6's look-back on 2^25 steps (one "
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
            want = segscan.masked_depth_cumsums_plain(path, rs, m, hc)
            errs.compare("seg_scan (K6)",
                         segscan.masked_depth_cumsums(path, rs, m, hc),
                         want, f"{what}, head carry {hc}")
            hc_dev = torch.tensor(hc, dtype=torch.int32, device="cuda")
            errs.compare("seg_scan (K6)",
                         segscan.masked_depth_cumsums(path, rs, m, hc_dev),
                         want, f"{what}, head carry {hc} on the device")
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

    from pollen_tpu_torch import profiling
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
        replays = profiling.counters().get("depth.route_replays", 0)
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
        # A replayed single query launches its captured scan pass and
        # boundary stage without their wrappers, which count the rest.
        replays = profiling.counters().get("depth.route_replays", 0) - replays
        moved[key] += replays
        moved["boundary"] += replays
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


def compare_probes(errs, cross, m, what, suffix=""):
    """K10-K12 on one matrix and mask against their plain versions, one
    launch a call (the wrappers' counters); v2 with its flags all 1, all
    0 and from tile_flags. Errors go to the rows named with ``suffix``."""
    import torch

    from pollen_tpu_torch.kernels import crossprobe as cp

    for mode, name in (("raw", "cross_probe_raw (K10)"),
                       ("vd", "cross_probe_vd (K10)"),
                       ("v1", "cross_probe_v1 (K11)")):
        one_launch(errs, name + suffix,
                   functools.partial(getattr(cp, f"cross_probe_{mode}"), cross, m),
                   functools.partial(cp.cross_probe_plain, cross, m, mode),
                   f"cross_probe_{mode}", cp.launches, what)
    n_tiles = cp.n_tiles(cross.shape[1])
    for label, flags in (
        ("ones", torch.ones(n_tiles, dtype=torch.int32, device="cuda")),
        ("zeros", torch.zeros(n_tiles, dtype=torch.int32, device="cuda")),
        ("tile_flags", cp.tile_flags(cross)),
    ):
        one_launch(errs, "cross_probe_v2 (K12)" + suffix,
                   functools.partial(cp.cross_probe_v2, cross, m, flags),
                   functools.partial(cp.cross_probe_plain, cross, m, "v2", flags),
                   "cross_probe_v2", cp.launches, f"{what} flags {label}")


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
    from pollen_tpu_torch.kernels import crossprobe as cp

    # A matrix whose columns are a multiple of 128 and not of v2's
    # 512-column tile (a narrower last tile), and one of 2,500 byte rows
    # (past the 2,048-row list chunk, restaged per tile).
    for seed, (rows, cols), what in (
        (10, (64, 8192), "seeded 64 x 8192, every 5th 128-column tile complex"),
        (11, (64, 8320), "seeded 64 x 8320 (65 x 128), every 5th tile complex"),
        (12, (2500, 640), "seeded 2500 x 640, every 5th tile complex"),
    ):
        a = torch.from_numpy(probe_matrix(seed, rows, cols)).cuda()
        for m in [torch.from_numpy(rng.random(2 * rows) < 0.5).cuda()
                  for _ in range(4)] + [
                      torch.ones(2 * rows, dtype=torch.int32, device="cuda")]:
            compare_probes(errs, a, m, what)
    for mode in cp.MODES:
        fn = getattr(cp, f"cross_probe_{mode}")
        args = (cp.tile_flags(a),) if mode == "v2" else ()
        prof = device_profile(functools.partial(fn, a, m, *args), reps=3)
        print(f"cross_probe_{mode} call on the 2500 x 640 matrix: "
              f"{describe_profile(prof)}", flush=True)
        need(not prof or set(prof) == {"cross_kernel"},
             f"cross_probe_{mode} is not one cross_kernel launch: "
             f"{sorted(prof)}")
    torch.cuda.synchronize()
    print("phase 1 (K9-K12): the flat ELL kernel equals plain on 8 fixtures "
          "(build_ell with the planned K and K = 1, 2, 4, 16) and on path "
          "ids 5, 32768, 40000, 65535; the probe ladder (raw, vd, v1, v2 "
          "with flags all 1, all 0 and from tile_flags) equals plain on "
          "the fixtures' nibble matrices and seeded 64 x 8192, 64 x 8320 "
          "and 2500 x 640 matrices, 4 seeded masks and the all-ones mask "
          "(tolerance 0: exact int32); each probe call one launch "
          "(counters) and one cross_kernel, no packing launch (profiler)",
          flush=True)


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
    their plain versions and library calls: K10-K12 at bench_cross's
    and chr8_third's matrices under the all-ones mask (first held
    against plain under a seeded random mask too) and at the unfused
    heavy block under a seeded mask; the JSON line keeps chr8_third's
    rows and the unfused block's, as rows of their own."""
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

    _, dgu, _ = graphs["unfused"]
    hu = dgu.ell_heavy
    mu = torch.from_numpy(rng.random(dgu.num_paths) < 0.5).cuda()
    for name, cross, mask, suffix in (
        ("bench_cross", *probes["bench_cross"][:2], None),
        ("chr8_third", *probes["chr8_third"][:2], ""),
        ("unfused", hu, cm.pad_mask(mu, 2 * hu.shape[0]), UNFUSED_PROBES),
    ):
        rows, n = cross.shape
        if name != "unfused":
            # The probe path ran under the all-ones mask: a seeded random
            # one exercises the row skip and the folding at full size.
            m_rand = torch.from_numpy(rng.random(mask.numel()) < 0.5).cuda()
            compare_probes(errs, cross, m_rand & (mask != 0),
                           f"{name} matrix, a seeded random mask")
        compare_probes(errs, cross, mask, f"{name} matrix, the timed mask",
                       suffix or "")
        flags = cp.tile_flags(cross)
        mp = cm.pad_mask(mask, 2 * rows)
        # The bound counts the byte rows the mask selects (a row whose
        # two paths are both out of the mask is never read, by any rung),
        # the mask, the outputs (and v2's flags).
        live = int(((mp[0::2] != 0) | (mp[1::2] != 0)).sum())
        io = live * n + 2 * rows + 8 * n
        print(f"probes at {name}: the mask selects {int((mp != 0).sum())} "
              f"paths, {live} of {rows} byte rows", flush=True)
        # The library calls: float32 products of the (folded) mask and a
        # copy of A made ahead of time (raw: the even paths against the
        # bytes as they are; the rest: the unpacked nibbles), depth only.
        even, raw_f = mp[0::2].float()[None], cross.float()
        fm, a_f = cm.fold_mask(mp).float()[None], cm.unpack_cross(cross).float()
        where = f"{name} matrix {tuple(cross.shape)}"
        times = {
            "cross_probe_raw (K10)": (
                functools.partial(cp.cross_probe_raw, cross, mask),
                functools.partial(cp.cross_probe_plain, cross, mask, "raw"),
                where, bound(io, tensor_ops=2 * live * n),
                lambda: torch.matmul(even, raw_f),
            ),
            "cross_probe_vd (K10)": (
                functools.partial(cp.cross_probe_vd, cross, mask),
                functools.partial(cp.cross_probe_plain, cross, mask, "vd"),
                where, bound(io, tensor_ops=2 * 2 * live * n),
                lambda: torch.matmul(fm, a_f),
            ),
            "cross_probe_v1 (K11)": (
                functools.partial(cp.cross_probe_v1, cross, mask),
                functools.partial(cp.cross_probe_plain, cross, mask, "v1"),
                where, bound(io, tensor_ops=4 * 2 * live * n),
                lambda: torch.matmul(fm, a_f),
            ),
            "cross_probe_v2 (K12)": (
                functools.partial(cp.cross_probe_v2, cross, mask, flags),
                functools.partial(cp.cross_probe_plain, cross, mask, "v2", flags),
                f"{where}, {int(flags.sum())}/{flags.numel()} tiles of "
                f"{cp.TILE} flagged",
                bound(io + 4 * flags.numel(), tensor_ops=4 * 2 * live * n),
                lambda: torch.matmul(fm, a_f),
            ),
        }
        rows_out = time_kernels(times, card)
        if suffix is not None:  # bench_cross's rows are printed only
            out.update({f"{k}{suffix}": v for k, v in rows_out.items()})
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


# ---------------------------------------------------------------------------
# The graph commands beyond depth and the writer. Their device ops have no
# TPU kernel and no CUDA kernel of their own: plain torch on the card.
# ---------------------------------------------------------------------------

# The graph of tests/golden/tiny.flatgfa.hex (tests/test_golden_binary.py).
HEX_GFA = "S\t1\tAC\nS\t2\tG\nP\tp\t1+,2-\t*\nL\t1\t+\t2\t+\t2M\n"
# (arguments after -I, golden extension)
GOLDEN_COMMANDS = (
    (("degree",), "degree"),
    (("flatten",), "flatten"),
    (("validate",), "validate"),
    (("matrix-adj",), "matrix"),
    (("paths",), "paths"),
    (("norm",), "norm"),
    (("crush",), "crush"),
    (("flip",), "flip"),
    (("chop", "-c", "3"), "chop"),
)


def cpu_checked_commands(stem: str) -> list:
    """Commands with no golden: on cuda they must print the port's
    ``--device cpu`` answer."""
    golden = REPO / "tests" / "golden"
    bed = str(golden / f"{stem}.bed")
    p0 = (golden / f"{stem}.paths").read_text().split()[0]
    return [
        ["depth", "-b", bed], ["window-depth", p0, "7"],
        ["bed-depth", "-b", bed], ["position", "-p", f"{p0},3,+"],
        ["position", "-p", f"{p0},100000,+"], ["stats"], ["stats", "-L"],
        ["toc"], ["toc", "-b"],
    ]


def phase_goldens_commands(tmp: pathlib.Path):
    """Phase 2 (graph commands): every command beyond depth through
    ``fgfa-torch --device cuda`` on the 8 fixtures, against the goldens
    or the port's ``--device cpu`` answer; ``-o``, ``-O``, the GFA round
    trip, and one serve stream of them mixed with depth requests."""
    import contextlib

    golden = REPO / "tests" / "golden"
    n_runs = 0
    # Flatten's FASTA name is the input path: the goldens were made with
    # tests/graphs/<stem>.og, so the fixtures are named from the root.
    with contextlib.chdir(REPO):
        for path in sorted((REPO / "tests" / "graphs").glob("*.gfa")):
            stem = path.stem
            rel = f"tests/graphs/{path.name}"
            all_paths = tmp / f"{stem}.allpaths"
            all_paths.write_text((golden / f"{stem}.paths").read_text())
            broken = tmp / f"{stem}.broken.gfa"
            broken.write_text((golden / f"{stem}.validate_setup").read_text())
            checks = [(["-I", rel, *argv], golden / f"{stem}.{ext}")
                      for argv, ext in GOLDEN_COMMANDS]
            checks += [
                (["-I", rel, "overlap", "--paths", str(all_paths)],
                 golden / f"{stem}.overlap"),
                (["-I", str(broken), "validate"],
                 golden / f"{stem}.validate_broken"),
                (["-I", rel], path),
            ]
            for argv, want in checks:
                got = run_cli(["--device", "cuda", *argv])
                need(got == want.read_text(),
                     f"{' '.join(argv)} differs from {want.name} on cuda")
            for argv in cpu_checked_commands(stem):
                got = run_cli(["--device", "cuda", "-I", rel, *argv])
                want = run_cli(["--device", "cpu", "-I", rel, *argv])
                need(got == want, f"{' '.join(argv)} on {path.name}: cuda "
                     "differs from cpu")
            outs = []
            for device in ("cuda", "cpu"):
                out = tmp / f"{stem}.{device}.gfa"
                run_cli(["--device", device, "-I", rel, "-O", str(out)])
                outs.append(out.read_text())
            need(outs[0] == outs[1] == path.read_text(),
                 f"-O on {path.name}: cuda, cpu and the input differ")
            n_runs += len(checks) + 2 * len(cpu_checked_commands(stem)) + 2
    tiny = tmp / "tiny.gfa"
    tiny.write_text(HEX_GFA)
    run_cli(["--device", "cuda", "-I", str(tiny), "-o",
             str(tmp / "tiny.flatgfa")])
    want = bytes.fromhex((golden / "tiny.flatgfa.hex").read_text().strip())
    need((tmp / "tiny.flatgfa").read_bytes() == want,
         "-o differs from tiny.flatgfa.hex")

    rand1 = REPO / "tests" / "graphs" / "rand1.gfa"
    all_paths = tmp / "rand1.allpaths"
    requests = [
        "degree", "depth -d", f"overlap --paths {all_paths}", "validate",
        f"depth -d -s {golden / 'rand1.depthpaths'}", "flatten",
        *(" ".join(argv) for argv in cpu_checked_commands("rand1")),
        "matrix-adj", "flip", "depth -d", "chop -c 3", "crush", "norm",
        f"-o {tmp / 'served.flatgfa'} depth -d", "paths",
    ]
    text = {}
    for device in ("cuda", "cpu"):
        text[device] = run_cli(["--device", device, "-I", str(rand1),
                                "serve"], "\n".join(requests) + "\n")
    frames = [ln for ln in text["cuda"].splitlines() if ln.startswith("##end")]
    need(frames == ["##end\tok"] * len(requests), f"serve frames: {frames}")
    need(text["cuda"] == text["cpu"], "serve on cuda differs from cpu")
    need(text["cuda"].startswith((golden / "rand1.degree").read_text()
                                 + "##end\tok\n"
                                 + (golden / "rand1.depth").read_text()),
         "serve's degree / depth answers differ from the goldens")
    run_cli(["--device", "cuda", "-I", str(rand1), "-o",
             str(tmp / "rand1.flatgfa")])
    need((tmp / "served.flatgfa").read_bytes()
         == (tmp / "rand1.flatgfa").read_bytes(), "served -o differs")
    print(f"phase 2 (graph commands): {n_runs} CLI runs on cuda for 8 "
          "fixtures: degree, flatten, overlap, validate (both goldens), "
          "matrix-adj, paths, norm, crush, flip, chop -c 3 and the GFA "
          "round trip byte-identical to the goldens; depth -b, window-depth, "
          "bed-depth, position, stats, toc and -O equal to --device cpu; -o "
          f"equals tiny.flatgfa.hex; serve answered {len(requests)} mixed "
          "requests ##end ok, equal to cpu", flush=True)


def add_path_links(g, seed=8):
    """``g`` with links: the unique adjacent handle pairs of every path,
    a seeded 1 in 10^4 of them dropped (so that validate has errors to
    report). Returns (graph, links kept, links dropped)."""
    import dataclasses

    import numpy as np

    sp = g.step_path_ids()
    same = sp[:-1] == sp[1:]
    a = g.steps[:-1][same].astype(np.uint64)
    b = g.steps[1:][same].astype(np.uint64)
    keys = np.unique((a << np.uint64(32)) | b)
    keep = np.random.default_rng(seed).random(keys.shape[0]) >= 1e-4
    kept = keys[keep]
    linked = dataclasses.replace(
        g,
        link_from=(kept >> np.uint64(32)).astype(np.uint32),
        link_to=(kept & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        link_overlap=np.zeros((kept.shape[0], 2), np.uint32),
    )
    return linked, int(kept.shape[0]), int((~keep).sum())


def numpy_graph_ops(g, pid: int, offsets, windows: int) -> dict:
    """Each device op of the graph commands as a numpy formula over the
    arena, independent of the port's code."""
    import numpy as np

    n, p = g.num_segments, g.num_paths
    steps = g.steps.astype(np.int64)
    seg = steps >> 1
    lens_seg = g.seg_len.astype(np.int64)
    out = {}
    out["seg_degree"] = np.bincount(
        np.concatenate([g.link_from >> 1, g.link_to >> 1]).astype(np.int64),
        minlength=n,
    )
    ends = np.cumsum(lens_seg)
    out["step_intervals"] = ((ends - lens_seg)[seg], ends[seg])

    keys = np.sort((g.link_from.astype(np.uint64) << np.uint64(32))
                   | g.link_to.astype(np.uint64))

    def member(k):
        idx = np.minimum(np.searchsorted(keys, k), keys.shape[0] - 1)
        return keys[idx] == k

    a, b = g.steps[:-1].astype(np.uint64), g.steps[1:].astype(np.uint64)
    sp = g.step_path_ids()
    one = np.uint64(1)
    out["_unsupported_pairs"] = (sp[:-1] == sp[1:]) & ~(
        member((a << np.uint64(32)) | b)
        | member(((b ^ one) << np.uint64(32)) | (a ^ one))
    )

    lo, hi = (int(x) for x in g.path_steps[pid])
    lens = lens_seg[seg[lo:hi]]
    cum = np.cumsum(lens)
    idx = np.minimum(np.searchsorted(cum, offsets, side="right"), hi - lo - 1)
    out["positions_in_path"] = (
        steps[lo + idx], offsets - (cum[idx] - lens[idx]),
        offsets < cum[-1],
    )

    shared = np.zeros((p, p), np.float32)
    chunk = 1 << 20
    for c0 in range(0, 2 * n, chunk):
        sel = (steps >= c0) & (steps < c0 + chunk)
        inc = np.zeros((p, min(chunk, 2 * n - c0)), np.float32)
        inc[sp[sel], steps[sel] - c0] = 1
        shared += inc @ inc.T
    out["_touch_matrix"] = (shared > 0) & ~np.eye(p, dtype=bool)

    bounds = g.path_steps.astype(np.int64)
    rev = (steps & 1).astype(bool)
    step_bp = lens_seg[seg]
    csum = np.concatenate(([0], np.cumsum(np.where(rev, step_bp, 0))))
    fsum = np.concatenate(([0], np.cumsum(np.where(rev, 0, step_bp))))
    out["_reverse_heavy_paths"] = (
        (csum[bounds[:, 1]] - csum[bounds[:, 0]])
        > (fsum[bounds[:, 1]] - fsum[bounds[:, 0]])
    )

    # Window depth as odgi's sweep, step by step, one window at a time:
    # the bp-weighted segment depth over each window, accumulated in the
    # reference's float64 order.
    depth = np.bincount(seg, minlength=n).astype(np.float64)
    total = int(cum[-1])
    w_lo = list(range(0, total, windows))
    acc = [0.0] * len(w_lo)
    start = 0
    for s_seg, s_len in zip(seg[lo:hi].tolist(), lens.tolist()):
        end = start + s_len
        for w in range(start // windows, min((end - 1) // windows + 1,
                                              len(w_lo))):
            wl, wh = w_lo[w], min(w_lo[w] + windows, total)
            ov = min(end, wh) - max(start, wl)
            if ov > 0:
                acc[w] += (depth[s_seg] * s_len * (ov / s_len)) / (wh - wl)
        start = end
    out["interval_depth"] = np.array(acc, dtype=np.float64)
    return out


GRAPH_OP_REFS = {
    "seg_degree": "pollen_tpu/ops/degree.py:20",
    "step_intervals": "pollen_tpu/ops/flatten.py:23",
    "_unsupported_pairs": "pollen_tpu/ops/validate.py:30",
    "positions_in_path": "pollen_tpu/ops/position.py:22",
    "_touch_matrix": "pollen_tpu/ops/overlap.py:31",
    "_reverse_heavy_paths": "pollen_tpu/ops/transform.py:86",
    "interval_depth": "pollen_tpu/ops/window_depth.py:26",
}


def max_err(got, want) -> float:
    import numpy as np

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    need(len(got) == len(want), "output counts differ")
    worst = 0.0
    for x, y in zip(got, want):
        x = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
        y = y.cpu().numpy() if hasattr(y, "cpu") else np.asarray(y)
        need(x.shape == y.shape, f"shapes {x.shape} and {y.shape} differ")
        if x.size:
            diff = np.abs(x.astype(np.float64) - y.astype(np.float64))
            worst = max(worst, float(diff.max()))
            need(np.array_equal(x, y), f"max |err| {float(diff.max())}")
    return worst


def need_same_from_numpy(name, from_numpy, from_tensors):
    """An op given the reference's numpy arrays on the card answers as
    it does given tensors: every output on cuda, of the same dtype and
    shape, equal exactly."""
    import torch

    pairs = list(zip(from_numpy, from_tensors))
    need(len(pairs) == len(from_tensors) == len(from_numpy)
         and all(a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
                 for a, b in pairs),
         f"{name}: numpy inputs on cuda differ from tensor inputs")
    print(f"{name}: numpy inputs on cuda equal tensor inputs", flush=True)


def device_op_row(name, reference, shape, fn, check, nbytes, card,
                  on_card=True):
    """One ``device_ops`` row: ``fn``'s answer held by ``check`` (against
    a CPU copy and a numpy formula; it raises on a difference and returns
    the largest error), then its CUDA-event wall, CUDA-graph device time
    (an op that answers on the host, ``on_card=False``, cannot be
    captured), profiler busy time, idle share and byte bound."""
    from pollen_tpu_torch.probes.timing import HBM_BPS, replay_us

    got = fn()
    if on_card:
        outs = got if isinstance(got, tuple) else (got,)
        need(all(o.is_cuda for o in outs), f"{name}: not on the card")
    err = check(got)
    wall_us = cuda_ms(fn) * 1e3
    dev_us = replay_us(fn) if on_card else None
    # No device events in the trace: busy time and idle share were not
    # measured (not zero).
    per = device_profile(fn, reps=10)
    busy = sum(per.values()) if per else None
    idle = None if busy is None else 1 - busy / wall_us
    bound_us = nbytes / HBM_BPS * 1e6
    dev = ("not graph-safe" if dev_us is None else
           f"{dev_us:.2f} us device ({dev_us / bound_us:.1f}x its bound)")
    busy_text = describe_profile(per) + (
        "" if busy is None else f", idle {idle:.3f}")
    print(f"{name} at {shape} [{card}]: {wall_us:.2f} us wall, {dev}, "
          f"{busy_text}; byte bound {bound_us:.2f} us; equal to cpu and "
          "numpy", flush=True)
    return dict(name=name, reference=reference, shape=shape,
                device_us=dev_us, wall_us=wall_us, bound_us=bound_us,
                busy_us=busy, idle_share=idle, max_abs_err=err)


def phase_graph_ops(graphs: dict, card: str) -> list:
    """Phase 3 (graph commands) at chr8_third with links: each device
    op on cuda against the same function on a CPU copy and a numpy
    formula, exact; then its CUDA-event wall, CUDA-graph device time
    (where the op is graph-safe), profiler busy time, idle share and
    byte bound; then CLI runs end to end over ``-i chr8.flatgfa``
    (written by the port's ``-o``)."""
    import numpy as np
    import torch

    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.bed import windows_bed
    from pollen_tpu_torch.fileformat import save_flatgfa
    from pollen_tpu_torch.ops import degree, flatten, overlap, position
    from pollen_tpu_torch.ops import transform, validate, window_depth

    g, linked, dropped = add_path_links(graphs["chr8_third"][0])
    t0 = time.perf_counter()
    dg = build_graph(g, "cuda", cross_matrix="never")
    torch.cuda.synchronize()
    print(f"chr8_third with links: {linked} links ({dropped} dropped); "
          f"ingest {time.perf_counter() - t0:.3f} s", flush=True)
    dg_cpu = dg.to("cpu")
    s, n, p = g.num_steps, g.num_segments, g.num_paths
    rng = np.random.default_rng(8)
    pid = 5
    lo, hi = (int(x) for x in g.path_steps[pid])
    total = int(g.seg_len[(g.steps[lo:hi] >> 1).astype(np.int64)].sum())
    offsets = np.sort(rng.integers(0, total + total // 8, 4096))
    offsets[:3] = (total - 1, total, total + 1)
    window = 1000
    windows = windows_bed(f"p{pid}".encode(), 0, total, window)
    want = numpy_graph_ops(g, pid, offsets, window)

    def args_of(d):
        steps = d.steps
        return dict(
            seg_degree=(d,),
            step_intervals=(d,),
            _unsupported_pairs=(
                steps, torch.from_numpy(g.step_path_ids()).to(d.device),
                torch.from_numpy(validate.link_keys(g)).to(d.device),
            ),
            positions_in_path=(d, pid, torch.from_numpy(offsets).to(d.device)),
            _touch_matrix=(overlap._incidence(g, d),),
            _reverse_heavy_paths=(d,),
            interval_depth=(g, d, pid, windows),
        )

    fns = dict(
        seg_degree=degree.seg_degree,
        step_intervals=flatten.step_intervals,
        _unsupported_pairs=validate._unsupported_pairs,
        positions_in_path=position.positions_in_path,
        _touch_matrix=overlap._touch_matrix,
        _reverse_heavy_paths=transform._reverse_heavy_paths,
        interval_depth=window_depth.interval_depth,
    )
    cuda_args, cpu_args = args_of(dg), args_of(dg_cpu)
    # The reference's numpy offsets, converted at the op's entry.
    need_same_from_numpy(
        "positions_in_path", position.positions_in_path(dg, pid, offsets),
        position.positions_in_path(*cuda_args["positions_in_path"]))
    idx_bytes = 8 * s + 4 * n  # steps (int64), seg_len
    nbytes = dict(
        seg_degree=4 * (n + 1) + 4 * n,
        step_intervals=idx_bytes + 2 * 8 * s,
        _unsupported_pairs=8 * s + 4 * s + 8 * g.num_links + (s - 1),
        positions_in_path=idx_bytes + 4 * (p + 1) + 8 * 4096 + 17 * 4096,
        _touch_matrix=p * 2 * n + p * p,
        _reverse_heavy_paths=idx_bytes + 4 * (p + 1) + p,
        interval_depth=4 * (n + 1) * 2 + 8 * n,
    )
    shapes = dict(
        seg_degree=f"N={n}", step_intervals=f"S={s}",
        _unsupported_pairs=f"S={s}, L={g.num_links}",
        positions_in_path=f"S={s}, Q=4096 on p{pid} ({hi - lo} steps)",
        _touch_matrix=f"incidence {p} x {2 * n}",
        _reverse_heavy_paths=f"S={s}, P={p}",
        interval_depth=f"p{pid}: {hi - lo} steps, "
                       f"{windows.num_entries} windows of {window} bp",
    )
    rows = []
    for name, fn in fns.items():
        def check(got, name=name, fn=fn):
            return max(max_err(got, fn(*cpu_args[name])),
                       max_err(got, want[name]))

        # interval_depth answers on the host (numpy).
        on_card = name != "interval_depth"
        rows.append(device_op_row(
            name, GRAPH_OP_REFS[name], shapes[name],
            functools.partial(fn, *cuda_args[name]), check, nbytes[name],
            card, on_card=on_card))

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        raw = tmp / "raw.flatgfa"
        save_flatgfa(str(raw), g)
        chr8 = tmp / "chr8.flatgfa"
        run_cli(["--device", "cuda", "-i", str(raw), "-o", str(chr8)])
        need(chr8.read_bytes() == raw.read_bytes(), "-o changed the graph")
        raw.unlink()
        (tmp / "paths.txt").write_text(
            "\n".join(b.decode() for b in g.path_names()) + "\n")
        bad = int(want["_unsupported_pairs"].sum())
        e2e = {}
        for argv, lines in (
            (["degree"], n + 1),
            (["validate"], bad),
            (["position", "-p", f"p{pid},{total // 2},+"], 2),
            (["window-depth", f"p{pid}", str(window)], windows.num_entries),
            (["overlap", "--paths", str(tmp / "paths.txt")],
             int(want["_touch_matrix"].sum()) + 1),
        ):
            t0 = time.perf_counter()
            text = run_cli(["--device", "cuda", "-i", str(chr8), *argv])
            e2e[argv[0]] = time.perf_counter() - t0
            need(text.count("\n") == lines,
                 f"{argv[0]} at chr8_third: {text.count(chr(10))} lines, "
                 f"expected {lines}")
    # flip and flatten render text per link and per step: timed at the
    # bench graph (2^22 steps), where their text takes seconds.
    gb, _, _ = add_path_links(graphs["bench"][0])
    with tempfile.TemporaryDirectory() as tmp:
        bench = pathlib.Path(tmp) / "bench.flatgfa"
        save_flatgfa(str(bench), gb)
        for argv in (["flip"], ["flatten"]):
            t0 = time.perf_counter()
            text = run_cli(["--device", "cuda", "-i", str(bench), *argv])
            e2e[f"{argv[0]} (bench)"] = time.perf_counter() - t0
            need(len(text) > gb.num_steps, f"{argv[0]} at bench: short text")
    print(f"CLI end to end [{card}], seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in e2e.items())
          + f" (chr8_third with links, -i chr8.flatgfa written by -o; flip "
          f"and flatten at bench with links)", flush=True)
    return rows


# ---------------------------------------------------------------------------
# The rest of the CLI: GAF lookup, pangenotype, extract, inject, seq-*,
# bench --wcl, and exine-torch (no kernel of their own either)
# ---------------------------------------------------------------------------


def numpy_chunker(seg_len, steps, read_bounds, start, end):
    """The reference's PathChunker state machine (gaf.rs
    PathChunker::next; ``tests/test_gaf_bed.py`` ``spec_chunker``) as a
    numpy formula: for each read, the first step reaching past ``start``
    opens the interval and the first step from there reaching past
    ``end`` closes it. Returns (kind, a, b); a and b hold the spec's
    values where kind is not NONE."""
    import numpy as np

    t = steps.shape[0]
    lens = seg_len[(steps >> 1).astype(np.int64)].astype(np.int64)
    counts = np.diff(read_bounds)
    rid = np.repeat(np.arange(counts.shape[0]), counts)
    first = np.repeat(read_bounds[:-1], counts)
    csum = np.concatenate(([0], np.cumsum(lens)))
    pos = csum[:-1] - csum[first]
    nxt = pos + lens
    idx = np.arange(t)
    s, e = start[rid], end[rid]
    big = np.int64(t)
    # First step of each read with nxt > start (nxt never decreases).
    open_at = np.full(counts.shape[0], big)
    np.minimum.at(open_at, rid, np.where(nxt > s, idx, big))
    close_at = np.full(counts.shape[0], big)
    np.minimum.at(close_at, rid, np.where(nxt > e, idx, big))
    o = open_at[rid]
    c = np.maximum(close_at[rid], o)
    kind = np.where(
        (idx == o) | ((idx == c) & (c > o)), 2,
        np.where((idx > o) & (idx < c), 1, 0),
    ).astype(np.uint8)
    a = np.where(idx == o, s - pos, 0)
    b = np.where(idx == c, e - pos, lens)
    return kind, a, b


def exine(argv) -> str:
    """``exine-torch`` with ``argv``; its stdout."""
    import contextlib

    from pollen_tpu_torch.accel.__main__ import main as exine_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exine_main(argv)
    return out.getvalue()


def sequential_names(path: pathlib.Path) -> bool:
    import numpy as np

    from pollen_tpu_torch import parse_gfa_file

    g = parse_gfa_file(str(path))
    return bool(g.num_segments and (
        g.seg_name == np.arange(1, g.num_segments + 1)).all())


def fixture_gafs(tmp: pathlib.Path, path: pathlib.Path, g) -> list:
    """Two seeded read sets of a graph's path sub-walks (1-40 steps, as
    benchsuite/runner.py ``ensure_gaf`` makes them; 40 reads each)."""
    from pollen_tpu_torch.synth import synth_gaf

    gafs = []
    for seed in (0, 1):
        gaf = tmp / f"{path.stem}.{seed}.gaf"
        gaf.write_bytes(synth_gaf(g, 40, seed=seed, max_steps=40))
        gafs.append(str(gaf))
    return gafs


def fixture_gaf_commands(tmp: pathlib.Path, path: pathlib.Path) -> list:
    """The GAF and extract command lines checked against ``--device cpu``
    on one graph: its two seeded read sets and a few neighborhoods."""
    from pollen_tpu_torch import parse_gfa_file

    g = parse_gfa_file(str(path))
    gafs = fixture_gafs(tmp, path, g)
    name = int(g.seg_name[g.num_segments // 2])
    sub = tmp / f"{path.stem}.sub.flatgfa"
    return [
        ["gaf", gafs[0]], ["gaf", "-s", gafs[0]], ["gaf", "-b", gafs[1]],
        ["gaf", "-b", "-p", gafs[0]], ["matrix", *gafs],
        ["pangenotype", gafs[1], gafs[0]],
        ["extract", "-n", str(name), "-c", "1"],
        ["extract", "-n", str(name), "-c", "2", "-d", "5", "-e", "2"],
        ["extract", "-n", str(int(g.seg_name[0])), "-c", "3", "-d", "0"],
        ["-o", str(sub), "extract", "-n", str(name), "-c", "2"],
    ]


def phase_goldens_gaf(tmp: pathlib.Path):
    """Phase 2 (the rest of the CLI): ``fgfa-torch --device cuda`` on the
    8 fixtures and on examples/example.gfa with example.gaf: ``inject``
    against the ``*.inject`` goldens; ``gaf`` (``-s``, ``-b``, ``-p``),
    ``matrix``, ``pangenotype`` and ``extract`` (and its ``-o``) against
    ``--device cpu``; the ``seq-export``/``seq-import`` round trip
    against tiny.packedseq.hex; ``bench --wcl [-p]`` against a newline
    count; ``exine-torch depth -a -r`` against the ``*.depth`` goldens
    (graphs named 1..N); one serve stream of them with ``depth -d``."""
    import contextlib

    golden = REPO / "tests" / "golden"
    n_runs = 0
    graphs = sorted((REPO / "tests" / "graphs").glob("*.gfa"))
    example = REPO / "examples" / "example.gfa"
    with contextlib.chdir(REPO):
        for path in graphs + [example]:
            cmds = fixture_gaf_commands(tmp, path)
            if path == example:
                gaf = str(REPO / "examples" / "example.gaf")
                cmds += [["gaf", gaf], ["gaf", "-s", gaf], ["gaf", "-b", gaf],
                         ["matrix", gaf, gaf], ["pangenotype", gaf]]
            for argv in cmds:
                outs = []
                for device in ("cuda", "cpu"):
                    text = run_cli(["--device", device, "-I", str(path),
                                    *argv])
                    if argv[0] == "-o":
                        text = pathlib.Path(argv[1]).read_bytes()
                    outs.append(text)
                need(outs[0] == outs[1] and outs[0],
                     f"{' '.join(argv)} on {path.name}: cuda differs from "
                     "cpu (or is empty)")
                n_runs += 2
            if path == example:
                continue
            got = run_cli(["--device", "cuda", "-I", str(path), "inject",
                           "--bed", str(golden / f"{path.stem}.bed")])
            need(got == (golden / f"{path.stem}.inject").read_text(),
                 f"inject on {path.name} differs from {path.stem}.inject")
            n_runs += 1
            if sequential_names(path):
                got = exine(["--device", "cuda", "depth", "-a", "-r",
                             str(path)])
                need(got == (golden / f"{path.stem}.depth").read_text(),
                     f"exine-torch depth -a -r on {path.name} differs from "
                     f"{path.stem}.depth")
                n_runs += 1

    seq = tmp / "tiny.seq"
    seq.write_text("AC\nTG A\n")
    packed = tmp / "tiny.packedseq"
    run_cli(["--device", "cuda", "seq-export", str(seq), str(packed)])
    want = bytes.fromhex((golden / "tiny.packedseq.hex").read_text().strip())
    need(packed.read_bytes() == want, "seq-export differs from "
         "tiny.packedseq.hex")
    need(run_cli(["--device", "cuda", "seq-import", str(packed)])
         == "ACTGA\n", "seq-import does not give ACTGA back")
    text = tmp / "lines.txt"
    text.write_bytes(b"".join(b"x" * (i % 97) + b"\n" for i in range(40000)))
    lines = text.read_bytes().count(b"\n")
    need(text.stat().st_size > 1 << 20, "bench --wcl file under 1 MiB")
    for extra in ([], ["-p"]):
        got = run_cli(["--device", "cuda", "bench", "--wcl", str(text),
                       *extra])
        need(got == f"{lines}\n", f"bench --wcl {extra}: {got!r}, "
             f"expected {lines}")
    n_runs += 4

    from pollen_tpu_torch import parse_gfa_file

    rand1 = REPO / "tests" / "graphs" / "rand1.gfa"
    gafs = fixture_gafs(tmp, rand1, parse_gfa_file(str(rand1)))
    requests = [
        f"gaf {gafs[0]}", "depth -d", f"matrix {gafs[0]} {gafs[0]}",
        "extract -n 3 -c 2", f"inject --bed {golden / 'rand1.bed'}",
        f"gaf -b {gafs[0]}", f"pangenotype {gafs[0]}", "depth -d",
        f"gaf -s {gafs[0]}",
    ]
    served = {}
    for device in ("cuda", "cpu"):
        served[device] = run_cli(["--device", device, "-I", str(rand1),
                                  "serve"], "\n".join(requests) + "\n")
    # gaf's plain text ends without a newline: its frame ends that line.
    need(served["cuda"].count("##end\t") == len(requests)
         == served["cuda"].count("##end\tok\n"),
         f"serve frames: {served['cuda'].count('##end')} of "
         f"{len(requests)}, not all ok")
    need(served["cuda"] == served["cpu"], "serve on cuda differs from cpu")
    print(f"phase 2 (the rest of the CLI): {n_runs} CLI runs on 8 fixtures "
          "and example.gfa: gaf (-s, -b, -p), matrix, pangenotype and "
          "extract (and its -o) equal to --device cpu; inject equal to the "
          "goldens; exine-torch depth -a -r equal to the depth goldens; "
          "seq-export / seq-import equal to tiny.packedseq.hex; bench --wcl "
          f"[-p] equal to {lines} lines; serve answered {len(requests)} "
          "mixed requests ##end ok, equal to cpu", flush=True)




def timed(e2e: dict, key: str, fn):
    t0 = time.perf_counter()
    out = fn()
    e2e[key] = time.perf_counter() - t0
    return out


def phase_gaf_ops(graphs: dict, card: str, kept: dict) -> list:
    """Phase 3 (the rest of the CLI) at chr8_third: ``chunk_reads`` over
    a seeded GAF of 2^20 long reads (sub-walks of 1-31 steps) and
    ``node_depth_accel`` on seeded memories (N = 2^16, E = 64, P = 128),
    each on cuda against a CPU copy and a numpy formula (the accelerator
    also against its single-PE form), exact, and timed as the graph
    commands' ops are; then CLI runs end to end, host clock: ``gaf -b``
    (its seconds split into load, ingest, parse and chunk), ``gaf`` over
    a 2^14-read prefix, ``pangenotype`` over 4 files of 2^18 reads,
    ``bench --wcl [-p]`` over the 2^20-read file, ``seq-export`` and
    ``seq-import`` over 16 MiB of bases, ``inject`` (the library call at
    chr8_third, the CLI at bench with links) and ``extract`` at the
    unfused graph. The 2^20-read GAF is left in ``kept["gaf"]`` for the
    API phase."""
    import numpy as np
    import torch

    from pollen_tpu_torch.accel.kernel import (
        node_depth_accel, node_depth_accel_simple,
    )
    from pollen_tpu_torch.bed import parse_bed
    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.fileformat import load_flatgfa, save_flatgfa
    from pollen_tpu_torch.ops import gaf as gaf_op
    from pollen_tpu_torch.ops.inject import inject
    from pollen_tpu_torch.synth import synth_gaf

    g, dg, _ = graphs["chr8_third"]
    n_reads = 2**20
    t0 = time.perf_counter()
    data = synth_gaf(g, n_reads, seed=17, max_steps=31)
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reads = gaf_op.parse_gaf(data, g.seg_id_by_name())
    parse_s = time.perf_counter() - t0
    kept["gaf"] = data
    t, r = reads.steps.shape[0], reads.num_reads
    print(f"chr8_third GAF: {r} reads, {t} read steps, {len(data)} bytes "
          f"(made in {made_s:.3f} s, parsed whole in {parse_s:.3f} s)",
          flush=True)
    read_id = np.repeat(np.arange(r, dtype=np.int32),
                        np.diff(reads.read_bounds))

    def chunk_args(device):
        return (dg.seg_len.to(device),
                torch.from_numpy(reads.steps.view(np.int32)).to(device),
                torch.from_numpy(read_id).to(device),
                torch.from_numpy(reads.start).to(device),
                torch.from_numpy(reads.end).to(device))

    def check_chunks(got):
        got = tuple(x.cpu() for x in got)
        need(got[0].dtype == torch.uint8 and got[1].dtype == torch.int64
             and got[2].dtype == torch.int64, "chunk_reads dtypes")
        err = max_err(got, gaf_op.chunk_reads(*chunk_args("cpu")))
        # The spec's a and b hold where a step is covered.
        kind, a, b = numpy_chunker(g.seg_len, reads.steps,
                                   reads.read_bounds, reads.start, reads.end)
        hit = kind != gaf_op.KIND_NONE
        k, ga, gb = (x.numpy() for x in got)
        return max(err, max_err((k, ga[hit], gb[hit]),
                                (kind, a[hit], b[hit])))

    # The reference's numpy arrays (uint32 handles) beside the graph's
    # seg_len on cuda, converted at the op's entry.
    need_same_from_numpy(
        "chunk_reads", gaf_op.chunk_reads(
            dg.seg_len.to("cuda"), reads.steps, read_id, reads.start,
            reads.end),
        gaf_op.chunk_reads(*chunk_args("cuda")))
    rows = [device_op_row(
        "chunk_reads", "pollen_tpu/ops/gaf.py:259",
        f"T={t} read steps, R={r} reads on chr8_third (N={g.num_segments})",
        functools.partial(gaf_op.chunk_reads, *chunk_args("cuda")),
        check_chunks,
        # steps, read id, the seg_len gather in; kind, a, b out; start
        # and end a read.
        t * (4 + 4 + 4 + 1 + 8 + 8) + 16 * r, card,
    )]

    rng = np.random.default_rng(8)
    n, e, p = 2**16, 64, 128
    ids = rng.integers(0, p + 1, (n, e)).astype(np.int32)
    ids[rng.random((n, e)) < 0.3] = 0  # empty slots
    consider = rng.integers(0, 2, p + 1).astype(np.int32)
    w = consider.copy()
    w[0] = 0
    present = np.zeros((n, p + 1), bool)
    present[np.repeat(np.arange(n), e), ids.reshape(-1)] = True
    accel_want = (w[ids].sum(1).astype(np.int32),
                  (present & (w > 0)).sum(1).astype(np.int32))
    simple = node_depth_accel_simple(torch.from_numpy(ids),
                                     torch.from_numpy(consider), p)
    need(all(np.array_equal(x.numpy(), y) for x, y in zip(simple,
                                                          accel_want)),
         "node_depth_accel_simple differs from numpy")

    def check_accel(got):
        cpu = node_depth_accel(torch.from_numpy(ids),
                               torch.from_numpy(consider), p)
        return max(max_err(got, cpu), max_err(got, accel_want))

    rows.append(device_op_row(
        "node_depth_accel", "pollen_tpu/accel/kernel.py:24",
        f"N={n}, E={e}, P={p}",
        functools.partial(node_depth_accel, torch.from_numpy(ids).cuda(),
                          torch.from_numpy(consider).cuda(), p),
        check_accel, 4 * n * e + 4 * (p + 1) + 2 * 4 * n, card,
    ))
    # A numpy consider beside path_ids on cuda; the single PE on the
    # first 256 nodes (it loops over nodes on the host).
    ids_cuda = torch.from_numpy(ids).cuda()
    cons_cuda = torch.from_numpy(consider).cuda()
    need_same_from_numpy(
        "node_depth_accel", node_depth_accel(ids_cuda, consider, p),
        node_depth_accel(ids_cuda, cons_cuda, p))
    need_same_from_numpy(
        "node_depth_accel_simple",
        node_depth_accel_simple(ids_cuda[:256], consider, p),
        node_depth_accel_simple(ids_cuda[:256], cons_cuda, p))

    e2e = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        chr8 = tmp / "chr8.flatgfa"
        save_flatgfa(str(chr8), g)
        reads_gaf = tmp / "reads.gaf"
        reads_gaf.write_bytes(data)
        cli = ["--device", "cuda", "-i", str(chr8)]
        text = timed(e2e, "gaf -b", lambda: run_cli(
            [*cli, "gaf", "-b", str(reads_gaf)]))
        need(text == f"{t}\n", f"gaf -b: {text!r}, expected {t}")
        # gaf -b's seconds, split: load, ingest, parse, chunk.
        split = {}
        g2 = timed(split, "load", lambda: load_flatgfa(str(chr8)))
        dg2 = timed(split, "ingest", lambda: build_graph(
            g2, "cuda", cross_matrix="never"))
        names = g2.seg_id_by_name()
        windows = timed(split, "parse", lambda: list(
            gaf_op.iter_gaf_windows(str(reads_gaf), names)))
        counts = timed(split, "chunk", lambda: [
            gaf_op.chunk_events(g2, dg2, w)[1].shape[0] for w in windows])
        need(sum(counts) == t, "windowed chunk counts differ")
        del dg2, g2, windows
        print(f"gaf -b at chr8_third [{card}]: {e2e['gaf -b']:.3f} s end to "
              f"end; alone: " + ", ".join(f"{k} {v:.3f} s"
                                          for k, v in split.items())
              + f" ({len(counts)} windows of 2 MiB)", flush=True)

        prefix = tmp / "prefix.gaf"
        cut = 0
        for _ in range(2**14):
            cut = data.index(b"\n", cut) + 1
        prefix.write_bytes(data[:cut])
        text = timed(e2e, "gaf (2^14 reads)", lambda: run_cli(
            [*cli, "gaf", str(prefix)]))
        need(text.count("\n") == 2**14, "gaf text: not a line a read")
        for extra in ([], ["-p"]):
            key = "bench --wcl" + (" -p" if extra else "")
            text = timed(e2e, key, lambda: run_cli(
                ["--device", "cuda", "bench", "--wcl", str(reads_gaf),
                 *extra]))
            need(text == f"{r}\n", f"{key}: {text!r}, expected {r}")
        del data, reads

        samples = []
        for s in range(4):
            path = tmp / f"sample{s}.gaf"
            path.write_bytes(synth_gaf(g, 2**18, seed=100 + s, max_steps=31))
            samples.append(str(path))
        text = timed(e2e, "pangenotype (4 x 2^18 reads)", lambda: run_cli(
            [*cli, "pangenotype", *samples]))
        rows_text = text.split("\n")
        need(len(rows_text) == 5 and rows_text[-1] == ""
             and all(len(x) == g.num_segments for x in rows_text[:4]),
             "pangenotype: wrong shape")
        first = gaf_op.parse_gaf_file(samples[0], g)
        row0 = np.zeros(g.num_segments, bool)
        row0[(first.steps >> 1).astype(np.int64)] = True
        need(rows_text[0] == (row0.astype(np.uint8) + 48).tobytes().decode(),
             "pangenotype's first row differs from its reads' segments")

        seq = tmp / "bases.txt"
        bases = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, 16 << 20)]
        body = np.full((bases.shape[0] // 60, 61), ord("\n"), np.uint8)
        body[:, :60] = bases[: body.shape[0] * 60].reshape(-1, 60)
        seq.write_bytes(body.tobytes() + bases[body.shape[0] * 60:].tobytes())
        packed = tmp / "bases.packedseq"
        timed(e2e, "seq-export (16 MiB)", lambda: run_cli(
            ["--device", "cuda", "seq-export", str(seq), str(packed)]))
        text = timed(e2e, "seq-import (16 MiB)", lambda: run_cli(
            ["--device", "cuda", "seq-import", str(packed)]))
        need(text.encode() == bases.tobytes() + b"\n",
             "seq-export / seq-import does not round-trip")

        # inject: the library call at chr8_third, 4 regions of 4 paths.
        lo = rng.integers(1000, 100000, 4)
        bed = "".join(f"p{i}\t{a}\t{a + 5000 + 37 * i}\tregion{i}\n"
                      for i, a in enumerate(lo))
        new_g = timed(e2e, "inject (library, chr8_third, 4 regions)",
                      lambda: inject(g, parse_bed(bed.encode())))
        need(new_g.num_paths == g.num_paths + 4, "inject: paths not added")
        for i in range(4):
            steps = new_g.path_step_slice(g.num_paths + i)
            got = int(new_g.seg_len[(steps >> 1).astype(np.int64)].sum())
            need(got == 5000 + 37 * i, f"inject region {i}: {got} bp")
        del new_g
    gb, _, _ = add_path_links(graphs["bench"][0])
    gu, _, _ = add_path_links(graphs["unfused"][0])
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        bench, unfused = tmp / "bench.flatgfa", tmp / "unfused.flatgfa"
        save_flatgfa(str(bench), gb)
        save_flatgfa(str(unfused), gu)
        bed_file = tmp / "regions.bed"
        bed_file.write_text(bed)
        text = timed(e2e, "inject (bench with links)", lambda: run_cli(
            ["--device", "cuda", "-i", str(bench), "inject", "--bed",
             str(bed_file)]))
        need(text.count("\nP\tregion") == 4, "inject CLI: paths missing")
        origin = str(gu.num_segments // 32)  # a segment of few steps
        text = timed(e2e, "extract (unfused with links)", lambda: run_cli(
            ["--device", "cuda", "-i", str(unfused), "extract", "-n", origin,
             "-c", "2"]))
        need(text.startswith(f"S\t{origin}\t"), "extract: origin not first")
    print(f"CLI end to end [{card}], seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in e2e.items())
          + " (gaf, pangenotype, bench, seq-* at chr8_third over -i; extract "
          "at the unfused graph with links: _merge_subpaths walks every "
          "path step by step in Python, 6 passes, so chr8_third would take "
          "minutes; inject's CLI at bench with links, where its sorted GFA "
          f"text takes seconds); extract printed {text.count(chr(10))} lines",
          flush=True)
    return rows


# Phase 4's traced query, in a process of its own: argv = the checkout,
# the .flatgfa file, the trace directory.
TRACE_CHILD = r"""
import sys
import torch
sys.path.insert(0, sys.argv[1])
import pollen_tpu_torch
from pollen_tpu_torch import profiling
from pollen_tpu_torch.ops.depth import masked_seg_depth
g = pollen_tpu_torch.load(sys.argv[2])
dg = g.device()
mask = torch.arange(g.arrays.num_paths) % 2 == 0
masked_seg_depth(dg, mask)
with profiling.device_trace(sys.argv[3]):
    masked_seg_depth(dg, mask)
"""


class _Messages(logging.Handler):
    """Keeps the messages of a logger, and prints them."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())
        print(f"  {record.name}: {record.getMessage()}", flush=True)


def api_reads_expected(g, reads, n):
    """Each of the first ``n`` reads' (name, chunk ranges, sequence), from
    ``numpy_chunker`` and the segments' bytes: what ``GAFLine`` and
    ``ChunkEvent`` must say (flatgfa-py's range encoding: skipped (1, 0),
    whole (0, len - 1))."""
    import numpy as np

    hi = int(reads.read_bounds[n])
    steps = reads.steps[:hi]
    seg_len = g.seg_len  # a property: computed over all segments
    kind, a, b = numpy_chunker(seg_len, steps, reads.read_bounds[: n + 1],
                               reads.start[:n], reads.end[:n])
    comp = bytes.maketrans(b"ACGTN", b"TGCAN")
    out = []
    for r in range(n):
        lo, up = int(reads.read_bounds[r]), int(reads.read_bounds[r + 1])
        ranges, seq = [], []
        for i in range(lo, up):
            seg = int(steps[i] >> 1)
            if kind[i] == 0:
                ranges.append((1, 0))
                continue
            text = g.seg_sequence(seg)
            if steps[i] & 1:
                text = text.translate(comp)[::-1]
            if kind[i] == 1:
                ranges.append((0, int(seg_len[seg]) - 1))
            else:
                ranges.append((int(a[i]), int(b[i])))
                text = text[int(a[i]):int(b[i])]
            seq.append(text.decode())
        out.append((reads.read_name(r).decode(), ranges, "".join(seq)))
    return out


def phase_api_shell(graphs: dict, gaf: bytes, card: str) -> dict:
    """Phase 4: the library API, the shell and the entry at chr8_third, on
    the card. ``save_flatgfa`` then ``pollen_tpu_torch.load`` (mmap,
    device cuda by default), spot-checked against the arena;
    ``g.device()`` (ingest, logged by ``profiling.stopwatch``) and the
    routed query (``ell``, fused K1) under three seeded masks against
    numpy's bincount and phase 3's index, timed by ``profiling.time_best``
    and ``cuda_ms`` (within 2x of each other) and traced once under
    ``profiling.device_trace`` in a process of its own (its Chrome trace
    must hold an event for each kernel launch, K1 among them); ``g.all_reads`` over the 2^20-read GAF (``chunk_reads`` on
    the card), the first 10,000 ``GAFLine``s against ``numpy_chunker``;
    a three-command ``flash-torch -O`` script (``depth -d``; p0's length
    into 100 kb windows redirected to ``win.bed``; interval depth over
    ``win.bed``; -O maps the binary once and keeps the windows in memory,
    so ``win.bed`` is never written) run through the console script on
    cuda and on the CPU, the same bytes, its ``-d`` table that of
    ``fgfa-torch depth -d``, its interval rows p0's windows; then
    ``entry("cuda")``'s forward and the routed query on its graph
    (``cross``, K2). Launch counts: reset before the API queries and
    read after them (K1), and again around the entry (K2)."""
    import itertools

    import numpy as np
    import torch

    import pollen_tpu_torch
    from pollen_tpu_torch import profiling
    from pollen_tpu_torch.entry import entry
    from pollen_tpu_torch.fileformat import save_flatgfa
    from pollen_tpu_torch.ops.depth import (
        _best_masked_impl, masked_seg_depth,
    )
    from pollen_tpu_torch.probes import trace_skew
    from pollen_tpu_torch.scripts import script_env
    from pollen_tpu_torch.shell import optimize, shell_to_ir

    g8, dg8, reference = graphs["chr8_third"]
    p = g8.num_paths
    out = {}
    keep = _Messages()
    logger = logging.getLogger("pollen_tpu_torch")
    logger.addHandler(keep)
    logger.setLevel(logging.INFO)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        flat = tmp / "chr8_third.flatgfa"
        t0 = time.perf_counter()
        save_flatgfa(str(flat), g8)
        out["save_flatgfa_s"] = time.perf_counter() - t0

        # 1. Load (mmap) and spot-check.
        g = pollen_tpu_torch.load(str(flat))
        need(g.torch_device == "cuda", "load: device is not cuda by default")
        need(len(g.segments) == g8.num_segments and len(g.paths) == p
             and len(g.links) == g8.num_links, "load: entity counts differ")
        for i in (0, g8.num_segments // 2, g8.num_segments - 1):
            seg = g.segments[i]
            need(seg.name == int(g8.seg_name[i])
                 and seg.sequence() == g8.seg_sequence(i)
                 and len(seg) == int(g8.seg_len[i]), f"segment {i} differs")
        need(g.segments.find(int(g8.seg_name[-1])).id == g8.num_segments - 1,
             "segments.find differs")
        lo, hi = (int(x) for x in g8.path_steps[0])
        path0 = g.paths[0]
        need(path0.name == g8.path_name_bytes(0) and len(path0) == hi - lo,
             "paths[0] differs")
        head = [(h.seg_id, h.is_forward) for h in path0[:1000]]
        want = [(int(s >> 1), not (s & 1)) for s in g8.steps[lo:lo + 1000]]
        need(head == want and path0[-1].seg_id == int(g8.steps[hi - 1] >> 1),
             "paths[0]'s steps differ")
        need(g.paths.find(g8.path_name_bytes(p - 1)).id == p - 1,
             "paths.find differs")

        # 2. Ingest and the routed single query (fused K1).
        with profiling.stopwatch("API ingest, g.device() at chr8_third"):
            dg = g.device()
            torch.cuda.synchronize()
        out["api_ingest_s"] = float(keep.messages[-1].rsplit(": ", 1)[1]
                                    .split()[0])
        need(g.device() is dg, "g.device() is not cached")
        need(dg.device.type == "cuda", "g.device() is not on the card")
        pick = _best_masked_impl(dg)
        need(pick == "ell" and plan_of(dg)["fused"],
             f"API index routes {pick!r}, plan {plan_of(dg)}")
        rng = np.random.default_rng(11)
        masks = [rng.random(p) < f for f in (0.5, 0.25, 0.75)]
        reset_launches()
        answers = [masked_seg_depth(dg, torch.from_numpy(m)) for m in masks]
        api_counts = launch_counts()
        need(api_counts["ell_splitn"] == len(masks),
             f"API queries: launches {api_counts}, expected "
             f"{len(masks)} of ell_splitn (K1)")
        for i, (m, (d, u)) in enumerate(zip(masks, answers)):
            d_np, u_np = reference(m)
            d3, u3 = masked_seg_depth(dg8, torch.from_numpy(m))
            need(np.array_equal(d, d_np) and np.array_equal(u, u_np),
                 f"API query mask {i}: differs from numpy's bincount")
            need(np.array_equal(d, d3) and np.array_equal(u, u3),
                 f"API query mask {i}: differs from phase 3's index")
        mt = torch.from_numpy(masks[0])
        best_ms = profiling.time_best(masked_seg_depth, dg, mt, reps=10) * 1e3
        event_ms = cuda_ms(lambda: masked_seg_depth(dg, mt))
        out.update(query_time_best_ms=best_ms, query_cuda_ms=event_ms)
        print(f"API query at chr8_third (route ell, K1) [{card}]: time_best "
              f"{best_ms:.3f} ms, cuda_ms {event_ms:.3f} ms (each a routed "
              "call: mask upload, K1, residual, host un-permute)", flush=True)
        need(0.5 <= best_ms / event_ms <= 2.0,
             f"time_best {best_ms:.3f} ms and cuda_ms {event_ms:.3f} ms "
             "differ by more than 2x")
        # The trace is taken in a process of its own, where it is the
        # first torch.profiler session: on the card's machine, CPU + CUDA
        # sessions after a process's first lost their kernel records
        # (CUDA-only sessions kept them). It runs beside the reads' host
        # parse below.
        traces = tmp / "trace"
        tracer = subprocess.Popen(
            [sys.executable, "-c", TRACE_CHILD, str(REPO), str(flat),
             str(traces)], stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)

        # 3. Reads: all_reads over the 2^20-read GAF.
        gaf_path = tmp / "reads.gaf"
        gaf_path.write_bytes(gaf)
        t0 = time.perf_counter()
        parser = g.all_reads(str(gaf_path))
        out["all_reads_s"] = time.perf_counter() - t0
        n = 10_000
        t0 = time.perf_counter()
        got = [(line.name, [c.range for c in line], line.sequence())
               for line in itertools.islice(parser, n)]
        out["gaflines_10000_s"] = time.perf_counter() - t0
        need(len(got) == n, f"all_reads: {len(got)} lines")
        need(got == api_reads_expected(g8, parser._reads, n),
             "all_reads: the first 10,000 GAFLines differ from numpy_chunker")
        print(f"all_reads at chr8_third [{card}]: {parser._reads.num_reads} "
              f"reads in {out['all_reads_s']:.3f} s (whole-file parse and "
              f"chunk_reads on the card); the first {n} GAFLines in "
              f"{out['gaflines_10000_s']:.3f} s, equal to numpy_chunker",
              flush=True)
        del parser
        child_out = tracer.communicate(timeout=300)[0].decode()
        need(tracer.returncode == 0, f"device_trace process: {child_out}")
        (trace,) = list(traces.iterdir())
        events = json.loads(trace.read_text())["traceEvents"]
        k1 = [e for e in events if str(e.get("cat", "")).lower() == "kernel"
              and "ell_splitn" in str(e.get("name", ""))]
        cats = {}
        for e in events:
            cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        skew = trace_skew.offsets(events)
        need(len(k1) == 1 and skew["kernels"] == skew["launches"],
             f"device_trace: {len(k1)} ell_splitn kernel events in "
             f"{trace.name} ({len(events)} events by category {cats}; "
             f"launches and events on the card: {skew})")
        out["trace_events"] = len(events)
        out["trace_offset_us"] = [skew["min_us"], skew["max_us"]]
        print(f"device_trace (its own process, API load, g.device(), one "
              f"warm query, then one traced): {trace.name}, {len(events)} "
              f"events, all {skew['launches']} kernel launches kept, K1 as "
              f"{k1[0]['name']!r} ({k1[0].get('dur')} us); events on the "
              f"card {skew['min_us']:.1f} to {skew['max_us']:.1f} us after "
              "their runtime calls", flush=True)

        # 4. The shell: one script, -O maps chr8_third.flatgfa (the .gfa
        # text is never written: a failed substitution fails to open it).
        gfa, win = tmp / "chr8_third.gfa", tmp / "win.bed"
        script = tmp / "chr8_third.sh"
        script.write_text(
            f"odgi depth -i {gfa} -d\n"
            f"odgi depth -i {gfa} -r p0 | bedtools makewindows -b /dev/stdin"
            f" -w 100000 > {win}\n"
            f"odgi depth -i {gfa} -b {win}\n")
        env = dict(script_env(), PYTHONFAULTHANDLER="1")

        def flash(*args):
            """``flash-torch`` in a process of its own: (stdout, seconds).
            Past 300 s it gets SIGABRT, so that its traceback shows where
            it stood, and the phase fails."""
            print(f"  flash-torch {' '.join(args[:-1])} ...", flush=True)
            t0 = time.perf_counter()
            proc = subprocess.Popen(["flash-torch", *args], cwd=tmp, env=env,
                                    stdin=subprocess.DEVNULL,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
            try:
                stdout, stderr = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.send_signal(signal.SIGABRT)
                stdout, stderr = proc.communicate()
            secs = time.perf_counter() - t0
            need(proc.returncode == 0, f"flash-torch {args}: exit "
                 f"{proc.returncode} after {secs:.1f} s: "
                 f"{stderr.decode()[-4000:]}")
            return stdout, secs

        # -O maps the binary once, reduces the path depth to its length
        # and elides the BED file's round trip: the windows go to the
        # interval depth in memory and win.bed is never written (the IR
        # that ``flash-torch -O -p`` prints).
        ir = optimize(shell_to_ir(script.read_text())).render()
        need("parse-gfa" not in ir and ir.count("map-file") == 1
             and "path-length" in ir and "make-windows" in ir
             and "parse-bed" not in ir and "win.bed" not in ir,
             f"flash-torch -O: unexpected IR\n{ir}")
        runs = {}
        for device in ("cuda", "cpu"):
            stdout, secs = flash("-O", "--device", device, str(script))
            need(not win.exists(), "flash-torch -O wrote win.bed")
            runs[device] = stdout
            out[f"flash_{device}_s"] = secs
        need(runs["cuda"] == runs["cpu"],
             "flash-torch: the cuda and cpu runs' stdout differ")
        t0 = time.perf_counter()
        d_table = run_cli(["--device", "cuda", "-i", str(flat), "depth",
                           "-d"]).encode()
        out["fgfa_depth_d_s"] = time.perf_counter() - t0
        stdout = runs["cuda"]
        need(stdout.startswith(d_table), "flash-torch's -d table differs "
             "from fgfa-torch depth -d")
        # The interval rows: p0's 100 kb windows over its whole length.
        steps0 = g8.path_step_slice(g8.path_id_by_name(b"p0"))
        p0_bp = int(g8.seg_len[(steps0 >> 1).astype(np.int64)].sum())
        starts = range(0, p0_bp, 100000)
        rest = stdout[len(d_table):].decode().split("\n")
        rows = [r.split("\t")[:3] for r in rest[1:-1]]
        need(rest[0] == "#path\tstart\tend\tmean.depth" and rest[-1] == ""
             and rows == [["p0", str(a), str(min(a + 100000, p0_bp))]
                          for a in starts],
             f"flash-torch interval depth: {len(rows)} rows, p0 is {p0_bp} "
             "bp")
        n_win = len(rows)
        print(f"flash-torch -O at chr8_third [{card}]: cuda run "
              f"{out['flash_cuda_s']:.3f} s, cpu run {out['flash_cpu_s']:.3f}"
              f" s (each a process: start-up, mmap, one ingest, -d table, "
              f"{n_win} windows, interval depth); fgfa-torch depth -d in "
              f"process {out['fgfa_depth_d_s']:.3f} s", flush=True)
        del g, dg

    # 5. The entry on the card: forward, then the routed query (K2).
    reset_launches()
    forward, (dge, mask) = entry("cuda")
    depth, uniq = forward(dge, mask)
    need(depth.is_cuda and depth.tolist() == [2, 3, 1, 1]
         and uniq.tolist() == [2, 2, 1, 1],
         f"entry: depth {depth.tolist()}, uniq {uniq.tolist()}")
    pick = _best_masked_impl(dge)
    d_r, u_r = masked_seg_depth(dge, mask)
    entry_counts = launch_counts()
    need(pick == "cross" and entry_counts["cross"] == 1,
         f"entry's graph: route {pick!r}, launches {entry_counts}")
    need(d_r.tolist() == [2, 3, 1, 1] and u_r.tolist() == [2, 2, 1, 1],
         "entry's graph: the routed query differs from the forward")
    logger.removeHandler(keep)
    print(f"entry('cuda'): forward depth {depth.tolist()}, uniq "
          f"{uniq.tolist()}; masked_seg_depth (route cross) equal", flush=True)
    out["launches"] = {"api queries": api_counts, "entry": entry_counts}
    return out


# --- phase 5: the native host code, the spec oracle, the permuted ELL
# query and the ELL and transform probes ---------------------------------

# Seeded tests/graphgen.py graphs of the spec phase: seed -> (segments,
# paths, N fraction, walk length). 11-13 are tests/test_random_parity.py's.
SPEC_GRAPHS = {
    11: (35, 7, 0.15, 30),
    12: (35, 7, 0.15, 30),
    13: (35, 7, 0.15, 30),
    21: (400, 16, 0.1, 200),
    22: (1000, 24, 0.1, 500),
}
# (fgfa-torch arguments after -I, the same command's spec CLI arguments
# before the graph): "{paths}" is a file of every path, "{half}" one of
# every other path.
SPEC_COMMANDS = (
    (("depth", "-d"), ("depth",)),
    (("depth", "-d", "-s", "{half}"), ("depth", "--paths", "{half}")),
    (("degree",), ("degree",)),
    (("matrix-adj",), ("matrix",)),
    (("flatten",), ("flatten",)),
    (("overlap", "--paths", "{paths}"), ("overlap", "--paths", "{paths}")),
    (("validate",), ("validate",)),
    (("crush",), ("crush",)),
    (("flip",), ("flip",)),
    (("chop", "-c", "1"), ("chop", "-n", "1")),
    (("chop", "-c", "4"), ("chop", "-n", "4")),
)
# The heavy-free graph of the probe phase: steps over segments uniformly
# (mean 8 runs a segment), planned at tiers of 4, 16 and 32 slots.
HEAVY_FREE = (2**22, 2**19, 128)
HEAVY_FREE_KS = (4, 16, 32)


def same_arrays(a, b) -> list:
    """Names of the arena fields where ``a`` and ``b`` differ."""
    import dataclasses

    import numpy as np

    return [f.name for f in dataclasses.fields(a)
            if not np.array_equal(getattr(a, f.name), getattr(b, f.name))]


def text_arena(g, seed=8):
    """``g`` ready to print as GFA and read back unchanged: seeded ACGT
    sequence bytes (the synthesis leaves them zero), a line order of its
    segments, then its paths, then its links, and each link's overlap
    the one CIGAR op that GFA's ``0M`` reads as (count 0, op M = code 0;
    the paths' overlaps ``*``)."""
    import dataclasses

    import numpy as np

    from pollen_tpu_torch.flatgfa import LINE_LINK, LINE_PATH, LINE_SEGMENT

    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, g.seq_data.shape[0])
    ]
    order = np.concatenate([
        np.full(g.num_segments, LINE_SEGMENT, np.uint8),
        np.full(g.num_paths, LINE_PATH, np.uint8),
        np.full(g.num_links, LINE_LINK, np.uint8),
    ])
    nl = g.num_links
    spans = np.stack([np.arange(nl), np.arange(nl) + 1], 1).astype(np.uint32)
    return dataclasses.replace(
        g, seq_data=seq, line_order=order, link_overlap=spans, overlaps=spans,
        alignment=np.zeros(nl, np.uint32),
        path_overlaps=np.full((g.num_paths, 2), nl, np.uint32),
    )


def numpy_emit(g) -> str:
    """The NumPy emitter's preserved-order text (the native path off)."""
    from pollen_tpu_torch.emit import emit_gfa

    with mock.patch.dict(os.environ, {"POLLEN_NATIVE": "0"}):
        return emit_gfa(g, order="preserved")


def numpy_flatgfa(g, path, spare=0.0) -> bytes:
    from pollen_tpu_torch.fileformat import save_flatgfa

    save_flatgfa(str(path), g, spare=spare)
    return pathlib.Path(path).read_bytes()


def phase_native_fixtures(tmp: pathlib.Path) -> int:
    """Native on the 8 fixtures: the scanner's arrays equal the NumPy
    parser's under POLLEN_SCAN_THREADS = 1 and the default, its emit the
    NumPy emit and the input bytes (to a string and to a file), and its
    converter parse + save, byte for byte. Returns the checks made."""
    from pollen_tpu_torch import native
    from pollen_tpu_torch.flatgfa import parse_gfa

    checks = 0
    for path in sorted((REPO / "tests" / "graphs").glob("*.gfa")):
        data = path.read_bytes()
        want = parse_gfa(data, native=False)
        for threads in ({"POLLEN_SCAN_THREADS": "1"}, {}):
            with mock.patch.dict(os.environ, threads):
                got = native.parse_gfa_native(data)
            need(got is not None, f"the scanner rejected {path.name}")
            bad = same_arrays(got, want)
            need(not bad, f"native parse of {path.name} (threads "
                 f"{threads or 'default'}) differs in {bad}")
            checks += 1
        text = native.emit_gfa_native(got)
        need(text == numpy_emit(want) == data.decode(),
             f"native emit of {path.name} differs from the NumPy emit or "
             "the input")
        out = tmp / f"{path.stem}.native.gfa"
        need(native.emit_gfa_file_native(got, str(out))
             and out.read_bytes() == data,
             f"native file emit of {path.name} differs from the input")
        for spare in (0.0, 0.5):
            conv = tmp / f"{path.stem}.native.flatgfa"
            need(native.convert_gfa_native(data, str(conv), spare),
                 f"the converter rejected {path.name}")
            need(conv.read_bytes()
                 == numpy_flatgfa(want, tmp / "py.flatgfa", spare),
                 f"convert_gfa_native of {path.name} (spare {spare}) "
                 "differs from parse + save_flatgfa")
        checks += 4
    return checks


def phase_capi(tmp: pathlib.Path):
    """The C API: build the port's capi.cpp + gfa_scan.cpp and example.c
    with g++, run the example on tiny.gfa (tests/test_capi.py's
    assertions) and on a file it must refuse."""
    src = REPO / "pollen_tpu_torch" / "native"
    d = tmp / "capi"
    d.mkdir()
    for cmd in (
        ["g++", "-O2", "-shared", "-fPIC", "-pthread", "-std=c++17", "-o",
         str(d / "libpollen_capi.so"), str(src / "capi.cpp"),
         str(src / "gfa_scan.cpp"), "-I", str(src)],
        ["g++", str(src / "example.c"), "-o", str(d / "example"), "-I",
         str(src), "-L", str(d), "-lpollen_capi", f"-Wl,-rpath,{d}"],
    ):
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        need(proc.returncode == 0, f"C API build failed: {proc.stderr}")
    out = subprocess.run([str(d / "example"), "tests/graphs/tiny.gfa"],
                         capture_output=True, text=True, timeout=60,
                         cwd=REPO)
    need(out.returncode == 0, f"C API example failed: {out.stderr}")
    for line in ("segments: 4", "seg 2: GATTACA", "paths: 2",
                 "alpha: 0+ 1+ 2+"):
        need(line in out.stdout, f"C API example: no {line!r}")
    bad = tmp / "bad.gfa"
    bad.write_text("X\tnope\n")
    fail = subprocess.run([str(d / "example"), str(bad)],
                          capture_output=True, text=True, timeout=60)
    need(fail.returncode == 1 and "parse failed" in fail.stderr,
         "C API example accepted a bad file")


def mb_s(nbytes: int, s: float) -> str:
    return f"{s:.3f} s ({nbytes / s / 1e6:.1f} MB/s)"


def timed_s(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def fgfa_convert(gfa: pathlib.Path, out: pathlib.Path) -> float:
    """Seconds of one ``fgfa-torch --device cuda -I gfa -o out`` run (the
    console script, interpreter start included)."""
    from pollen_tpu_torch.scripts import script_env

    t0 = time.perf_counter()
    proc = subprocess.run(
        ["fgfa-torch", "--device", "cuda", "-I", str(gfa), "-o", str(out)],
        capture_output=True, text=True, timeout=600, env=script_env(),
        cwd=REPO,
    )
    need(proc.returncode == 0, f"fgfa-torch -o failed: {proc.stderr[-2000:]}")
    return time.perf_counter() - t0


def phase_native_scale(graphs: dict, tmp: pathlib.Path, card: str) -> dict:
    """Native at scale: bench and chr8_third with links as GFA text. At
    both the native parse equals the arena the text was printed from; at
    bench also the NumPy parse, and the emit (to a string and to a file)
    and the conversion, native against NumPy, each pair equal; at
    chr8_third the converter equals parse + save. Each time with the
    text's bytes and MB/s; ``fgfa-torch -I x.gfa -o y.flatgfa`` end to
    end at both."""
    from pollen_tpu_torch import native
    from pollen_tpu_torch.flatgfa import parse_gfa

    out = {}
    for name in ("bench", "chr8_third"):
        g, n_links, _ = add_path_links(graphs[name][0])
        g = text_arena(g)
        gfa = tmp / f"{name}.gfa"
        need(native.emit_gfa_file_native(g, str(gfa)),
             f"{name}: the native file emit fell back")
        data = gfa.read_bytes()
        nbytes = len(data)
        row = dict(text_bytes=nbytes, links=n_links)
        t_parse, got = timed_s(lambda: native.parse_gfa_native(data))
        need(got is not None, f"{name}: the scanner rejected the text")
        bad = same_arrays(got, g)
        need(not bad, f"{name}: native parse differs from the printed arena "
             f"in {bad}")
        row["parse_native_s"] = t_parse
        line = f"{name} with links as GFA ({nbytes} bytes): native parse " \
               f"{mb_s(nbytes, t_parse)}"
        if name == "bench":
            t_np, want = timed_s(lambda: parse_gfa(data, native=False))
            bad = same_arrays(got, want)
            need(not bad, f"bench: native parse differs from NumPy in {bad}")
            with mock.patch.dict(os.environ, {"POLLEN_SCAN_THREADS": "1"}):
                t_one, one = timed_s(lambda: native.parse_gfa_native(data))
            need(not same_arrays(one, want), "bench: one-thread parse differs")
            t_emit, text = timed_s(lambda: native.emit_gfa_native(got))
            t_emit_np, text_np = timed_s(lambda: numpy_emit(got))
            need(text == text_np and text.encode() == data,
                 "bench: native emit differs from the NumPy emit or the text")
            f_nat, f_np = tmp / "bench.emit.native.gfa", tmp / "bench.emit.np.gfa"
            t_file, ok = timed_s(
                lambda: native.emit_gfa_file_native(got, str(f_nat)))
            need(ok, "bench: the native file emit fell back")

            def write_np():
                with open(f_np, "w", encoding="ascii") as f:
                    f.write(numpy_emit(got))

            t_file_np, _ = timed_s(write_np)
            need(f_nat.read_bytes() == f_np.read_bytes() == data,
                 "bench: the file emits differ")
            row.update(parse_numpy_s=t_np, parse_native_1thread_s=t_one,
                       emit_native_s=t_emit, emit_numpy_s=t_emit_np,
                       emit_file_native_s=t_file,
                       emit_file_numpy_s=t_file_np)
            line += (f", one thread {mb_s(nbytes, t_one)}, NumPy "
                     f"{mb_s(nbytes, t_np)} (equal); emit native "
                     f"{mb_s(nbytes, t_emit)}, NumPy {mb_s(nbytes, t_emit_np)}"
                     f"; to a file native {mb_s(nbytes, t_file)}, NumPy "
                     f"{mb_s(nbytes, t_file_np)} (equal bytes)")
        conv = tmp / f"{name}.native.flatgfa"
        t_conv, ok = timed_s(
            lambda: native.convert_gfa_native(data, str(conv)))
        need(ok, f"{name}: the converter rejected the text")
        want_bytes = numpy_flatgfa(got, tmp / f"{name}.py.flatgfa")
        need(conv.read_bytes() == want_bytes,
             f"{name}: convert_gfa_native differs from parse + save_flatgfa")
        cli_out = tmp / f"{name}.cli.flatgfa"
        t_cli = fgfa_convert(gfa, cli_out)
        need(cli_out.read_bytes() == want_bytes,
             f"{name}: fgfa-torch -o differs from parse + save_flatgfa")
        row.update(convert_native_s=t_conv, fgfa_torch_convert_s=t_cli,
                   flatgfa_bytes=len(want_bytes))
        line += (f"; convert_gfa_native {mb_s(nbytes, t_conv)}; fgfa-torch "
                 f"--device cuda -I -o {mb_s(nbytes, t_cli)} end to end "
                 f"({len(want_bytes)} bytes out, equal to parse + save)")
        print(f"{line} [{card}]", flush=True)
        for p in (gfa, conv, cli_out, tmp / f"{name}.py.flatgfa"):
            p.unlink()
        out[name] = row
    return out


def phase_spec(tmp: pathlib.Path) -> dict:
    """The spec oracle on the card: seeded graphgen graphs (the reference
    parity test's seeds 11-13 and two larger) through ``fgfa-torch
    --device cuda``, every command byte for byte against the same
    command of the spec's CLI; then ``pollen-spec-torch``
    against the goldens of the 8 fixtures (one run through the console
    script, the rest through its ``run`` in this process)."""
    import contextlib

    sys.path.insert(0, str(REPO / "tests"))
    from graphgen import random_graph

    from pollen_tpu_torch.scripts import script_env
    from pollen_tpu_torch.spec import __main__ as spec_main
    from pollen_tpu_torch.spec.model import Graph

    runs = 0
    steps = {}
    for seed, (n_segs, n_paths, n_frac, walk) in SPEC_GRAPHS.items():
        text = random_graph(seed=seed, n_segs=n_segs, n_paths=n_paths,
                            n_frac=n_frac, walk_len=walk)
        gfa = tmp / f"spec{seed}.gfa"
        gfa.write_text(text)
        spec_graph = Graph.parse_lines(iter(text.splitlines()))
        names = list(spec_graph.paths)
        steps[seed] = sum(len(p.steps) for p in spec_graph.paths.values())
        files = {"paths": tmp / f"spec{seed}.paths",
                 "half": tmp / f"spec{seed}.half"}
        files["paths"].write_text("\n".join(names) + "\n")
        files["half"].write_text("\n".join(names[::2]) + "\n")
        for argv, spec_argv in SPEC_COMMANDS:
            argv, spec_argv = ([a.format(**files) for a in v]
                               for v in (argv, spec_argv))
            got = run_cli(["--device", "cuda", "-I", str(gfa), *argv])
            want = io.StringIO()
            spec_main.run(spec_main.build_parser().parse_args(
                [*spec_argv, str(gfa)]), want)
            need(got == want.getvalue(), f"spec seed {seed}: fgfa-torch "
                 f"{' '.join(argv)} on cuda differs from the spec")
            runs += 1
    golden = REPO / "tests" / "golden"
    kinds = {"depth": [], "degree": [], "matrix": [], "paths": [],
             "validate": [], "flatten": [], "norm": [], "crush": [],
             "flip": [], "chop": ["-n", "3"]}
    proc = subprocess.run(
        ["pollen-spec-torch", "depth", "tests/graphs/tiny.gfa"],
        capture_output=True, text=True, timeout=120, env=script_env(),
        cwd=REPO,
    )
    need(proc.returncode == 0 and proc.stdout
         == (golden / "tiny.depth").read_text(),
         f"pollen-spec-torch depth tiny.gfa: {proc.stderr[-500:]}")
    goldens = 1
    with contextlib.chdir(REPO):
        for path in sorted((REPO / "tests" / "graphs").glob("*.gfa")):
            stem = path.stem
            rel = f"tests/graphs/{path.name}"
            extra = {
                "depth_subset": ["depth", "--paths",
                                 str(golden / f"{stem}.depthpaths")],
                "overlap": ["overlap", "--paths",
                            str(golden / f"{stem}.paths")],
                "inject": ["inject", "--bed", str(golden / f"{stem}.bed")],
            }
            argvs = {k: [k, *a] for k, a in kinds.items()} | extra
            for kind, argv in argvs.items():
                args = spec_main.build_parser().parse_args([*argv, rel])
                buf = io.StringIO()
                spec_main.run(args, buf)
                need(buf.getvalue() == (golden / f"{stem}.{kind}").read_text(),
                     f"pollen-spec-torch {kind} {path.name} differs from "
                     "its golden")
                goldens += 1
    print(f"spec oracle: {runs} fgfa-torch --device cuda runs on "
          f"{len(SPEC_GRAPHS)} seeded graphgen graphs ({sorted(steps.values())}"
          f" steps) equal to pollen_tpu_torch.spec byte for byte; "
          f"pollen-spec-torch reproduced {goldens} goldens of the 8 "
          "fixtures", flush=True)
    return dict(cli_runs=runs, goldens=goldens, graph_steps=steps)


def compose_permuted_host(dg, parts):
    """The parts composed on the host in ``ell_order``, no un-permute:
    [tier 1, tiers 2+3, heavy, empty] (numpy, independent of the
    port's concatenate)."""
    import numpy as np

    d1, u1, d2, u2, dh, uh = (None if x is None else x.cpu().numpy()
                              for x in parts)
    n = dg.num_segments
    if d2 is None and dh is None and not dg.ell_order.shape[0]:
        return d1[:n], u1[:n]
    nl, nh = dg.ell_num_light, dg.ell_num_heavy
    nm = dg.ell_num_mid + dg.ell_num_mid2
    d, u = [d1[:nl]], [u1[:nl]]
    if d2 is not None:
        d.append(d2[:nm])
        u.append(u2[:nm])
    if dh is not None:
        d.append(dh[:nh])
        u.append(uh[:nh])
    empty = np.zeros(n - nl - nm - nh, np.int32)
    return np.concatenate(d + [empty]), np.concatenate(u + [empty])


def phase_permuted(graphs: dict, card: str) -> dict:
    """``seg_depth_with_uniq_ell_permuted`` on bench, chr8_third and
    unfused under 8 seeded masks each: equal to the kernels' parts
    composed on the host without the un-permute, and, un-permuted, to
    the plain sorted-step path and numpy. Counted as a path of its own:
    the counts are set to 0 before each permuted call and read just
    after it, before any reference runs, and each call must launch K1 at
    bench and chr8_third, K3 and K2 at unfused. One call timed against
    the host-composed ``seg_depth_with_uniq_ell``."""
    import numpy as np
    import torch

    from pollen_tpu_torch.ops import depth as depth_op
    from pollen_tpu_torch.probes.timing import replay_us

    rng = np.random.default_rng(12)
    out = {}
    for name, keys in (("bench", ("ell_splitn",)),
                       ("chr8_third", ("ell_splitn",)),
                       ("unfused", ("ell_tier", "cross"))):
        g, dg, reference = graphs[name]
        order = dg.ell_order.cpu().numpy()
        counts = dict.fromkeys(launch_counts(), 0)
        for i, m in enumerate(scale_masks(g.num_paths, rng)):
            mt = torch.from_numpy(m).cuda()
            reset_launches()
            d, u = depth_op.seg_depth_with_uniq_ell_permuted(dg, mt)
            call = launch_counts()
            for key in keys:
                need(call[key] > 0, f"{name} mask {i}: permuted launched "
                     f"{call}")
            counts = {k: counts[k] + v for k, v in call.items()}
            need(d.is_cuda and d.dtype == torch.int32 and d.shape
                 == (g.num_segments,), f"{name}: permuted {d.shape} {d.dtype}")
            d, u = d.cpu().numpy(), u.cpu().numpy()
            parts = depth_op.seg_depth_with_uniq_ell_parts(dg, mt)
            hd, hu = compose_permuted_host(dg, parts)
            need(np.array_equal(d, hd) and np.array_equal(u, hu),
                 f"{name} mask {i}: permuted differs from the host compose")
            if order.shape[0]:
                nd, nu = np.empty_like(d), np.empty_like(u)
                nd[order], nu[order] = d, u
            else:
                nd, nu = d, u
            pd, pu = (t.cpu().numpy() for t in
                      depth_op.seg_depth_with_uniq_masked(dg, mt))
            rd, ru = reference(m)
            need(np.array_equal(nd, pd) and np.array_equal(nu, pu)
                 and np.array_equal(nd, rd) and np.array_equal(nu, ru),
                 f"{name} mask {i}: un-permuted differs from plain or numpy")
        m = torch.from_numpy(rng.random(g.num_paths) < 0.5).cuda()
        perm_ms = cuda_ms(
            lambda: depth_op.seg_depth_with_uniq_ell_permuted(dg, m))
        perm_dev = replay_us(
            lambda: depth_op.seg_depth_with_uniq_ell_permuted(dg, m))
        host_ms = cuda_ms(lambda: depth_op.seg_depth_with_uniq_ell(dg, m))
        print(f"{name} [{card}]: permuted 8 masks equal to the host compose, "
              f"plain and numpy; launches {counts}; one call {perm_ms * 1e3:.2f}"
              f" us wall ({perm_dev:.2f} us device), host-composed "
              f"seg_depth_with_uniq_ell {host_ms * 1e3:.2f} us wall", flush=True)
        out[name] = dict(launches=counts, permuted_us=perm_ms * 1e3,
                         permuted_device_us=perm_dev,
                         host_composed_us=host_ms * 1e3)
    return out


def heavy_free_graph():
    """(arena, index on the card) of ``HEAVY_FREE`` (steps over segments
    uniformly), planned with no heavy class."""
    import dataclasses

    import numpy as np

    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.probes.ell_probe import three_tiers
    from pollen_tpu_torch.synth import synth_graph

    n_steps, n_segs, _ = HEAVY_FREE
    g = synth_graph(*HEAVY_FREE)
    segs = np.random.default_rng(9).integers(0, n_segs, n_steps)
    g = dataclasses.replace(g, steps=segs.astype(np.uint32) << np.uint32(1))
    with three_tiers(HEAVY_FREE_KS):
        dg = build_graph(g, "cuda")
    need(not dg.ell_heavy.numel() and dg.ell_pack16,
         f"heavy-free graph planned a heavy block {tuple(dg.ell_heavy.shape)}")
    return g, dg


def phase_ell_probes(graphs: dict, card: str) -> dict:
    """The probes on the card: ``ell_probe``'s check stages (ellok,
    ellbok, ellp16ok) at bench and at a heavy-free graph, diff 0; the
    calibration points (ellcal, and ellcal1 hrot); scanb, runsk and
    scatter at bench; ``transform_probe``'s chop and crush at bench."""
    from pollen_tpu_torch.probes import ell_probe, transform_probe

    import torch

    g, dg, _ = graphs["bench"]
    _, dg_free = heavy_free_graph()
    n_steps = g.num_steps
    say = lambda s: print(f"  {s}", flush=True)  # noqa: E731
    out = {"checks": {}}
    print(f"ell_probe at bench: {ell_probe.describe(dg)}; heavy-free "
          f"{HEAVY_FREE}: {ell_probe.describe(dg_free)} [{card}]", flush=True)
    for where, d in (("bench", dg), ("heavy_free", dg_free)):
        for stage in ("ellok", "ellbok", "ellp16ok"):
            res = ell_probe.run_stage(stage, None, d, n_steps, say=say)
            need(res["diff"] == 0, f"{stage} at {where}: diff {res['diff']}")
            out["checks"][f"{stage} {where}"] = res["diff"]
    out["ellp16_heavy_free"] = ell_probe.run_stage(
        "ellp16", None, dg_free, HEAVY_FREE[0], say=say)
    out["ellcal"] = ell_probe.stage_ellcal(dg, say=say)
    out["hrot"] = ell_probe.stage_ellcal1(dg, "hrot:16384", say=say)
    for stage in ("ellraw", "scanb", "runsk", "scatter"):
        out[stage] = ell_probe.run_stage(stage, None, dg, n_steps, say=say)
    dev = torch.device("cuda")
    out["chop"] = transform_probe.stage_chop(g, dev, say=say)
    out["crush"] = transform_probe.stage_crush(g, dev, say=say)
    need(out["chop"]["equal"] and out["crush"]["equal"],
         "transform_probe: the device stages differ from the host's")
    del dg_free
    torch.cuda.empty_cache()
    return out


def phase_native_spec_probes(graphs: dict, card: str) -> dict:
    """Phase 5: the native layer (no hidden fallback: its build must
    succeed with POLLEN_NATIVE unset), the C API, native at scale, the
    spec oracle, the permuted ELL query as a path of its own, then the
    probes, K1-K4 and K6-K8 launched by this phase."""
    from pollen_tpu_torch import native

    need("POLLEN_NATIVE" not in os.environ, "POLLEN_NATIVE is set")
    t0 = time.perf_counter()
    need(native.native_available(),
         f"the native library did not build: {native.build_error}")
    out = {"library": native.library_path().name,
           "build_s": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        n = phase_native_fixtures(tmp)
        phase_capi(tmp)
        print(f"native: {out['library']} built in {out['build_s']:.2f} s; "
              f"{n} checks on the 8 fixtures equal (parse under 1 and the "
              "default scan threads, emit, file emit, convert); the C API "
              "example passed", flush=True)
        out["scale"] = phase_native_scale(graphs, tmp, card)
        out["spec"] = phase_spec(tmp)
    out["permuted"] = phase_permuted(graphs, card)
    permuted = {}
    for row in out["permuted"].values():
        for k, v in row["launches"].items():
            permuted[k] = permuted.get(k, 0) + v
    reset_launches()
    out["probes"] = phase_ell_probes(graphs, card)
    probes = launch_counts()
    total = {k: permuted.get(k, 0) + probes[k] for k in probes}
    for name in ("ell_splitn (K1)", "cross (K2)", "ell_tier (K3)",
                 "ell_splitn_batch (K4)", "seg_scan (K6)", "boundary (K7)",
                 "run_scan (K8)"):
        need(total[KERNELS[name][2]] > 0,
             f"{name} was never launched by phase 5")
    out["launches"] = {"permuted": permuted, "probes": probes}
    print(f"phase 5 launches: permuted {permuted}; probes {probes}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 6: the sharded path (pollen_tpu_torch/parallel/): every sharded query
# as one rank over NCCL in this process, then as two ranks on the one card
# over gloo at full size. The card's machine has one card, so this records
# no multi-card time: the two ranks' times are those of two ranks sharing it.
# ---------------------------------------------------------------------------

SHARDED_RANKS = 2
SHARDED_DEADLINE = 400  # s: the two-rank job, its graphs' builds included
SHARDED_LABEL = "2 ranks on one H100"
SHARDED_TIMED_RANK = 1  # its chunk's head group straddles the chunk bound


def ext_mask(m, device):
    """int32 [P + 1]: a 0/1 path mask and the padding sentinel's 0."""
    import torch

    m = torch.as_tensor(m).to(device=device, dtype=torch.int32)
    return torch.cat([m, m.new_zeros(1)])


def routed_device_fn(dg, m):
    """The single-device routed query's device part (no host copy): the
    route the router picks, on the card."""
    import functools

    from pollen_tpu_torch.ops import depth as depth_op

    route, fn = depth_op.masked_route_fn(dg)
    return route, functools.partial(fn, dg, m)


def routed_batch_fn(dg, masks):
    """The routed batch's device part, as :func:`routed_device_fn`."""
    import functools

    from pollen_tpu_torch.ops import depth as depth_op

    route, fn = depth_op.batch_route_fn(dg)
    return route, functools.partial(fn, dg, masks)


def lockstep_ms(fn, reps=10, warm=2):
    """Median CUDA-event wall of one call, with the same number of calls
    on every rank (a sharded query's collectives pair up across ranks;
    ``cuda_ms`` picks its count from the first call's time)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
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


class LaunchLog:
    """Launch counts by query: the counts set to 0 just before each call
    of a sharded query and read just after it, summed by label, and the
    calls by label."""

    def __init__(self):
        self.counts = {}
        self.runs = {}

    def run(self, label, fn):
        import torch

        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        self.runs[label] = self.runs.get(label, 0) + 1
        for k, v in launch_counts().items():
            if v:
                row = self.counts.setdefault(label, {})
                row[k] = row.get(k, 0) + v
        return out


def need_equal(got, want, what):
    """Exact equality of int vectors (tensors or arrays)."""
    import numpy as np

    g = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    w = want.cpu().numpy() if hasattr(want, "cpu") else np.asarray(want)
    need(g.shape == w.shape and np.array_equal(g, w),
         f"{what}: differs ({g.shape} vs {w.shape})")


def time_pair(rows, label, sharded_fn, single_fn):
    """The sharded query's wall and device busy time (every rank in
    step) beside the single-device routed query's, in us."""
    row = {}
    for key, fn in (("sharded", sharded_fn), ("single", single_fn)):
        if fn is None:
            continue
        wall = lockstep_ms(fn) * 1e3
        busy = sum(device_profile(fn, reps=5).values())
        row[key] = dict(wall_us=wall, busy_us=busy or None)
    rows[label] = row


def phase_sharded_one_rank() -> dict:
    """Phase 6, one rank over NCCL in this process (a 1 x 1 mesh): every
    sharded query on the 8 fixtures under two masks equals the single-
    device ``--device cuda`` answer; ``distributed.ingest`` equals
    ``build_graph`` on them; the fused query's local part runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync between
    the all-gather and K6)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from pollen_tpu_torch import parse_gfa_file
    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.ops import depth as depth_op
    from pollen_tpu_torch.ops.degree import seg_degree
    from pollen_tpu_torch.parallel import distributed, launch
    from pollen_tpu_torch.parallel import sharded as sh
    from pollen_tpu_torch.parallel.collectives import gather_shards

    log = LaunchLog()
    rng = np.random.default_rng(61)
    checks = 0
    with launch.world_of_one("cuda"):
        backend = dist.get_backend()
        need(backend == "nccl", f"one rank on the card runs {backend}, not nccl")
        mesh = sh.make_mesh()
        fns = {name: getattr(sh, f"sharded_seg_depth{name}_fn")(mesh)
               for name in ("", "_scatter", "_fused")}
        for path in sorted((REPO / "tests" / "graphs").glob("*.gfa")):
            g = parse_gfa_file(str(path))
            p, n = g.num_paths, g.num_segments
            dg = build_graph(g, "cuda")
            dga = build_graph(g, "cuda", cross_matrix="always")
            sg = sh.shard_device_graph(dg, mesh)
            sc = sh.shard_cross_inputs(dga, mesh)
            se = sh.shard_ell_inputs(dga, mesh)
            has = dict(has_heavy=se.heavy is not None, has_mid=se.ell2 is not None,
                       has_mid2=se.ell3 is not None)
            masks = [np.ones(p, bool), rng.random(p) < 0.5]
            for i, m in enumerate(masks):
                mt = torch.from_numpy(m).cuda()
                want = depth_op.masked_seg_depth(dg, mt)
                me = ext_mask(mt, "cuda")
                for name, fn in fns.items():
                    d, u = log.run(f"fused" if name == "_fused" else "scan",
                                   lambda: fn(sg, me))
                    if name == "_scatter":
                        d, u = gather_shards(d, mesh.get_group("chip"))[:n], \
                            gather_shards(u, mesh.get_group("chip"))[:n]
                    need_equal(d, want[0], f"{path.name} sharded{name} depth")
                    need_equal(u, want[1], f"{path.name} sharded{name} uniq")
                mp = torch.zeros(sc.num_paths_padded, dtype=torch.int32, device="cuda")
                mp[:p] = mt.to(torch.int32)
                d, u = log.run("cross", lambda: sh.sharded_cross_depth_fn(
                    mesh, nibble=sc.nibble)(sc.cross, sc.res, sc.res_seg, mp))
                need_equal(d[:n], want[0], f"{path.name} sharded cross depth")
                need_equal(u[:n], want[1], f"{path.name} sharded cross uniq")
                parts = log.run("ell", lambda: sh.sharded_ell_depth_fn(mesh, **has)(
                    *sh.ell_args(se, mt.to(torch.int32))))
                d, u = sh.compose_ell_parts_natural(dga, parts, **has)
                need_equal(d, want[0], f"{path.name} sharded ELL depth")
                need_equal(u, want[1], f"{path.name} sharded ELL uniq")
                checks += 5
            mb = torch.from_numpy(np.stack(masks)).cuda()
            parts = log.run("ell batch", lambda: sh.sharded_ell_depth_batch_fn(
                mesh, **has)(*sh.ell_args(se, mb.to(torch.int32))))
            want_b = depth_op.seg_depth_with_uniq_batch(dga, mb)
            for q in range(2):
                d, u = sh.compose_ell_parts_natural(dga, [x[q] for x in parts], **has)
                need_equal(d, want_b[0][q], f"{path.name} sharded ELL batch depth")
                need_equal(u, want_b[1][q], f"{path.name} sharded ELL batch uniq")
            deg = log.run("degree", lambda: sh.sharded_degree_fn(mesh)(
                *sh.shard_degree_inputs(dg, mesh)))
            need_equal(deg, seg_degree(dg), f"{path.name} sharded degree")
            # The rank-sharded ingest equals the single-process parse and
            # build_graph's chunk.
            arena = distributed.ingest_arena(str(path))
            bad = same_arrays(arena, g)
            need(not bad, f"{path.name}: ingest_arena differs in {bad}")
            sgi = distributed.ingest(str(path), mesh)
            for f in dataclasses.fields(sg):
                a, b = getattr(sgi, f.name), getattr(sg, f.name)
                same = torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                need(same, f"{path.name}: distributed.ingest's {f.name} differs "
                     "from build_graph's")
            checks += 4
        # No host sync between the all-gather and K6: the fused query runs
        # whole (after a warm-up call) with CUDA's sync debug mode on.
        g = parse_gfa_file(str(REPO / "tests" / "graphs" / "rand1.gfa"))
        sg = sh.shard_device_graph(build_graph(g, "cuda"), mesh)
        me = ext_mask(torch.ones(g.num_paths, dtype=torch.int32), "cuda")
        fns["_fused"](sg, me)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fns["_fused"](sg, me)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    need(log.counts.get("fused", {}).get("seg_scan", 0) > 0,
         "one rank: the fused sharded query never launched K6")
    need(log.counts.get("ell", {}).get("ell_flat", 0) == log.runs["ell"],
         f"one rank: {log.counts.get('ell', {}).get('ell_flat', 0)} K9 "
         f"launches in {log.runs['ell']} sharded ELL queries, want one each")
    print(f"phase 6, one rank over NCCL (torch {torch.__version__}): {checks} "
          "checks on the 8 fixtures equal the single-device --device cuda "
          "answers (cumsum, scatter and fused scan, crossing matrix, ELL, ELL "
          "batch, degree; ingest_arena and distributed.ingest equal the "
          "parse and build_graph); the fused query ran under "
          f"set_sync_debug_mode('error'); launches {log.counts}", flush=True)
    return {"checks": checks, "launches": log.counts, "sync_debug": "error"}


def sharded_kernel_rows(errs_out, k6, k9, k9_tiers, k2, k5):
    """The timed rank's kernel rows: K6 with its device carry on its
    chunk, K9 on its tier-1 slice and on its three tier slices in one
    launch (the sharded ELL query's call), K2 on its crossing-matrix
    slice, K5 on its heavy slice at Q = 32, each first held against its
    plain version on the same inputs."""
    import torch

    from pollen_tpu_torch.kernels import crossmat as cm
    from pollen_tpu_torch.kernels import ellscan as ell
    from pollen_tpu_torch.kernels import segscan

    times = {}
    path, rs, mask, carry, p, where = k6
    n = path.shape[0]
    ones = torch.ones((2, n), dtype=torch.int32, device="cuda")
    times[SHARDED_ROWS[0]] = (
        functools.partial(segscan.masked_depth_cumsums, path, rs, mask, carry),
        functools.partial(segscan.masked_depth_cumsums_plain, path, rs, mask, carry),
        where, bound(16 * n + p, core_ops=6 * n),
        lambda: torch.cumsum(ones, 1, dtype=torch.int32),
    )
    slots, m, p, where = k9
    k, n_pad = slots.shape
    flat_call = functools.partial(ell.masked_ell_depth, slots, m)
    times[SHARDED_ROWS[1]] = (
        flat_call, functools.partial(ell.masked_ell_depth_plain, slots, m), where,
        bound(4 * k * n_pad + 8 * n_pad + p, core_ops=4 * k * n_pad),
        ell_library(SHARDED_ROWS[1], flat_call, m, p, flat=slots),
    )
    tiers, m, p, where = k9_tiers
    cells = sum(e.numel() for e in tiers)
    cols = sum(e.shape[1] for e in tiers)
    tiers_call = functools.partial(ell.masked_ell_depth_tiers, tiers, m)
    # The yardstick's one flat block: the tiers side by side, each padded
    # with empty slots to the largest k (same outputs, in the same order).
    k_max = max(e.shape[0] for e in tiers)
    side = torch.cat([torch.nn.functional.pad(e, (0, 0, 0, k_max - e.shape[0]))
                      for e in tiers], dim=1)
    times[SHARDED_ROWS[2]] = (
        tiers_call,
        lambda: tuple(x for e in tiers for x in ell.masked_ell_depth_plain(e, m)),
        where, bound(4 * cells + 8 * cols + p, core_ops=4 * cells),
        ell_library(SHARDED_ROWS[2], tiers_call, m, p, flat=side),
    )
    cross, mp, nibble, where = k2
    rows, n = cross.shape
    p_rows = 2 * rows if nibble else rows
    a = cm.unpack_cross(cross) if nibble else cross.to(torch.int32)
    fm = (cm.fold_mask(mp) if nibble else mp).float()[None]
    a_lib = both_products(a).float()
    live = (int(((mp[0::2] != 0) | (mp[1::2] != 0)).sum()) if nibble
            else int((mp != 0).sum()))
    times[SHARDED_ROWS[3]] = (
        functools.partial(cm.masked_cross_depth, cross, mp, nibble=nibble),
        functools.partial(cm.masked_cross_depth_plain, cross,
                          cm.pad_mask(mp, p_rows), nibble=nibble),
        where, bound(live * n + p_rows + 8 * n, tensor_ops=4 * 2 * live * n),
        lambda: torch.matmul(fm, a_lib),
    )
    heavy, m32, p, where = k5
    q = m32.shape[0]
    mph = cm.pad_mask(m32, 2 * heavy.shape[0])
    a_both = both_products(cm.unpack_cross(heavy))
    library, _ = int_mm_or_matmul(cm.fold_mask(mph).to(torch.int8),
                                  a_both.to(torch.int8))
    times[SHARDED_ROWS[4]] = (
        functools.partial(cm.batched_cross_depth, heavy, m32, nibble=True),
        functools.partial(cm.batched_cross_depth_plain, heavy, mph, nibble=True),
        where, bound(heavy.numel() + q * p + 8 * q * heavy.shape[1],
                     tensor_ops=4 * q * heavy.numel() * 2),
        library,
    )
    for name, (kern, plain, where, _, _) in times.items():
        got, want = kern(), plain()
        err = 0
        for a, b in zip(got, want):
            err = max(err, int((a.long() - b.long()).abs().max()) if a.numel() else 0)
        need(err == 0, f"{name} at {where}: max |kernel - plain| {err}")
        errs_out[name] = err
    out = time_kernels(times, f"{SHARDED_LABEL}, rank {SHARDED_TIMED_RANK}")
    del a_lib, a_both
    torch.cuda.empty_cache()
    return out


def sharded_rank(rank, world, device, bench_gfa):
    """Phase 6's rank body (2 ranks on one card, gloo): wide_p2e17, then
    chr8_third with its crossing matrix, then bench's GFA text; every
    sharded answer gathered and held, exactly, against the single-device
    routed query on this rank and ``NumpyReference``. Launch counts are
    set to 0 before each sharded query and read after it. The timed rank
    times the four kernels last, alone (the other rank has left)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.flatgfa import parse_gfa_file
    from pollen_tpu_torch.ops import depth as depth_op
    from pollen_tpu_torch.ops.degree import seg_degree
    from pollen_tpu_torch.parallel import distributed
    from pollen_tpu_torch.parallel import sharded as sh
    from pollen_tpu_torch.parallel.collectives import all_reduce_sum, gather_shards
    from pollen_tpu_torch.synth import synth_graph

    t_start = time.perf_counter()
    mesh = sh.make_mesh()
    log = LaunchLog()
    rng = np.random.default_rng(62)  # the same masks on every rank
    times = {}
    out = {"rank": rank, "backend": dist.get_backend(), "torch": torch.__version__,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "times": times}
    chip = mesh.get_group("chip")

    # wide_p2e17 (route "scan"): the fused query on K6, cumsum, scatter.
    shape, opts, route = SCAN_SCALE["wide_p2e17"]
    g = synth_graph(*shape)
    dg = build_graph(g, device, **opts)
    ref = NumpyReference(dg)
    need(depth_op._best_masked_impl(dg) == route, "wide_p2e17 does not route scan")
    sg = sh.shard_device_graph(dg, mesh)
    straddles = int(all_reduce_sum(
        (sg.run_start[:1] < sg.chunk_starts[sg.index]).to(torch.int32)))
    need(straddles > 0, "wide_p2e17: no group straddles the chunk bound")
    fns = {"fused": sh.sharded_seg_depth_fused_fn(mesh),
           "cumsum": sh.sharded_seg_depth_fn(mesh),
           "scatter": sh.sharded_seg_depth_scatter_fn(mesh)}
    n = dg.num_segments
    masks = scale_masks(g.num_paths, rng)
    for i, m in enumerate(masks):
        mt = torch.from_numpy(m).to(device)
        me = ext_mask(mt, device)
        want = ref(m)
        single = depth_op.masked_seg_depth(dg, mt)
        for k in range(2):
            need_equal(single[k], want[k], f"wide_p2e17 single-device, mask {i}")
        for name, fn in fns.items():
            d, u = log.run(f"wide_p2e17 {name}", lambda: fn(sg, me))
            if name == "scatter":
                d, u = gather_shards(d, chip)[:n], gather_shards(u, chip)[:n]
            need_equal(d, want[0], f"wide_p2e17 sharded {name} depth, mask {i}")
            need_equal(u, want[1], f"wide_p2e17 sharded {name} uniq, mask {i}")
    mt = torch.from_numpy(masks[3]).to(device)
    me = ext_mask(mt, device)
    _, single_fn = routed_device_fn(dg, mt)
    for name, fn in fns.items():
        time_pair(times, f"wide_p2e17 {name}", functools.partial(fn, sg, me),
                  single_fn if name == "fused" else None)
    kargs = {"k6": (*sh.fused_scan_args(sg, me), g.num_paths + 1,
                    f"wide_p2e17 chunk {sg.index} of {world} ({sg.chunk} steps), "
                    "device carry")}
    out["wide_p2e17"] = {"straddles": straddles, "masks": len(masks),
                         "chunk": sg.chunk}
    del dg, sg, ref, g, single_fn
    torch.cuda.empty_cache()

    # chr8_third with its crossing matrix: ELL (three tiers and heavy),
    # its Q = 32 batch, the crossing matrix.
    g = synth_graph(*SCALE["chr8_third"])
    dg = build_graph(g, device, cross_matrix="always")
    ref = NumpyReference(dg)
    p, n = g.num_paths, dg.num_segments
    se = sh.shard_ell_inputs(dg, mesh)
    need(se.ell2 is not None and se.ell3 is not None and se.heavy is not None,
         "chr8_third: the ELL index is not three tiers and heavy")
    sc = sh.shard_cross_inputs(dg, mesh)
    need(sc is not None, "chr8_third: no crossing matrix")
    has = dict(has_heavy=True, has_mid=True, has_mid2=True)
    ell_fn = sh.sharded_ell_depth_fn(mesh, **has)
    batch_fn = sh.sharded_ell_depth_batch_fn(mesh, **has)
    cross_fn = sh.sharded_cross_depth_fn(mesh, nibble=sc.nibble)

    def padded(mt):
        mp = torch.zeros(sc.num_paths_padded, dtype=torch.int32, device=device)
        mp[:p] = mt.to(torch.int32)
        return mp

    masks = scale_masks(p, rng)
    for i, m in enumerate(masks):
        mt = torch.from_numpy(m).to(device)
        want = ref(m)
        single = depth_op.masked_seg_depth(dg, mt)
        for k in range(2):
            need_equal(single[k], want[k], f"chr8_third single-device, mask {i}")
        parts = log.run("chr8_third ell", lambda: ell_fn(*sh.ell_args(se, mt.to(torch.int32))))
        d, u = sh.compose_ell_parts_natural(dg, [gather_shards(x) for x in parts], **has)
        need_equal(d, want[0], f"chr8_third sharded ELL depth, mask {i}")
        need_equal(u, want[1], f"chr8_third sharded ELL uniq, mask {i}")
        mp = padded(mt)
        d, u = log.run("chr8_third cross",
                       lambda: cross_fn(sc.cross, sc.res, sc.res_seg, mp))
        need_equal(gather_shards(d)[:n], want[0], f"chr8_third sharded cross depth, mask {i}")
        need_equal(gather_shards(u)[:n], want[1], f"chr8_third sharded cross uniq, mask {i}")
    m32_np = batch_masks(p, rng)
    m32 = torch.from_numpy(m32_np.astype(np.int32)).to(device)
    parts = log.run("chr8_third ell batch", lambda: batch_fn(*sh.ell_args(se, m32)))
    parts = [gather_shards(x) for x in parts]
    single = depth_op.seg_depth_with_uniq_batch(dg, m32.bool())
    for q in range(m32.shape[0]):
        d, u = sh.compose_ell_parts_natural(dg, [x[q] for x in parts], **has)
        want = ref(m32_np[q])
        for got, one, nump, what in ((d, single[0][q], want[0], "depth"),
                                     (u, single[1][q], want[1], "uniq")):
            need_equal(got, one, f"chr8_third sharded ELL batch {what}, query {q}")
            need_equal(got, nump, f"chr8_third sharded ELL batch {what}, query {q}")
    mt = torch.from_numpy(masks[3]).to(device)
    m_int, mp = mt.to(torch.int32), padded(mt)
    route, single_fn = routed_device_fn(dg, mt)
    time_pair(times, "chr8_third ell", lambda: ell_fn(*sh.ell_args(se, m_int)), single_fn)
    time_pair(times, "chr8_third cross",
              lambda: cross_fn(sc.cross, sc.res, sc.res_seg, mp),
              functools.partial(depth_op.seg_depth_with_uniq_cross, dg, mt))
    b_route, single_b = routed_batch_fn(dg, m32.bool())
    time_pair(times, "chr8_third ell batch Q=32",
              lambda: batch_fn(*sh.ell_args(se, m32)), single_b)
    for name, t in (("tier 1", se.ell), ("tier 2", se.ell2), ("tier 3", se.ell3)):
        fn = functools.partial(sh.ell_tiers_batch, t, m32)
        times[f"chr8_third batched {name} plain, Q=32"] = {"plain": dict(
            wall_us=lockstep_ms(fn) * 1e3,
            busy_us=sum(device_profile(fn, reps=5).values()) or None,
            slots=list(t.shape))}
    out["chr8_third"] = {"routes": {"single": route, "batch": b_route},
                         "masks": len(masks), "batch": int(m32.shape[0]),
                         "ell_widths": [se.light_width, se.mid_width,
                                        se.mid2_width, se.heavy_width],
                         "cross_width": sc.col_width}
    kargs["k9"] = (se.ell, m_int, p, f"chr8_third tier-1 slice {tuple(se.ell.shape)}")
    kargs["k9_tiers"] = ([se.ell, se.ell2, se.ell3], m_int, p,
                         "chr8_third tier slices "
                         f"{[tuple(e.shape) for e in (se.ell, se.ell2, se.ell3)]}")
    kargs["k2"] = (sc.cross, mp, sc.nibble,
                   f"chr8_third crossing-matrix slice {tuple(sc.cross.shape)}")
    kargs["k5"] = (se.heavy, m32, p, f"chr8_third heavy slice {tuple(se.heavy.shape)}, Q=32")
    del dg, ref, g, single_fn, single_b, parts
    torch.cuda.empty_cache()

    # bench with links, as GFA text: the byte-range ingest's exchange, then
    # the sharded degree.
    t0 = time.perf_counter()
    arena = distributed.ingest_arena(bench_gfa)
    exchange_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    direct = parse_gfa_file(bench_gfa)
    parse_s = time.perf_counter() - t0
    bad = same_arrays(arena, direct)
    need(not bad, f"bench: the 2-rank ingest_arena differs from the parse in {bad}")
    dg = build_graph(direct, device)
    deg_fn = sh.sharded_degree_fn(mesh)
    inputs = sh.shard_degree_inputs(dg, mesh)
    deg = log.run("bench degree", lambda: deg_fn(*inputs))
    need_equal(deg, seg_degree(dg), "bench sharded degree vs seg_degree")
    ends = np.concatenate([direct.link_from >> 1, direct.link_to >> 1])
    need_equal(deg, np.bincount(ends.astype(np.int64), minlength=dg.num_segments),
               "bench sharded degree vs numpy")
    time_pair(times, "bench degree", lambda: deg_fn(*inputs),
              functools.partial(seg_degree, dg))
    out["bench"] = {"exchange_s": exchange_s, "parse_s": parse_s,
                    "gfa_bytes": os.path.getsize(bench_gfa),
                    "links": int(direct.num_links)}
    out["launches"] = log.counts
    out["runs"] = log.runs
    del dg, inputs
    torch.cuda.empty_cache()
    out["seconds_before_kernels"] = time.perf_counter() - t_start
    if rank == SHARDED_TIMED_RANK:
        out["kernel_errs"] = {}
        out["kernel_times"] = sharded_kernel_rows(out["kernel_errs"], **kargs)
    out["seconds"] = time.perf_counter() - t_start
    return out


def phase_sharded(graphs: dict, card: str) -> dict:
    """Phase 6: one rank over NCCL here, then two ranks on the one card
    over gloo at full size (sharded_rank); the launch gates of the
    sharded path; its ``{"sharded": ...}`` line's record."""
    import torch

    from pollen_tpu_torch.parallel import launch

    out = {"torch": torch.__version__, "label": f"{SHARDED_LABEL} [{card}]"}
    out["one_rank"] = phase_sharded_one_rank()
    with tempfile.TemporaryDirectory() as tmp:
        gfa = pathlib.Path(tmp) / "bench.gfa"
        gfa_text_file(graphs["bench"][0], gfa)
        t0 = time.perf_counter()
        ranks = launch.run(sharded_rank, SHARDED_RANKS, str(gfa), device="cuda",
                           deadline=SHARDED_DEADLINE)
        out["two_ranks_s"] = time.perf_counter() - t0
    out["two_ranks"] = ranks
    for r in ranks:
        need(r["backend"] == "gloo",
             f"rank {r['rank']} of two on one card ran {r['backend']}, not gloo")
        c = r["launches"]
        for label, key in (("wide_p2e17 fused", "seg_scan"),
                           ("chr8_third ell", "ell_flat"),
                           ("chr8_third ell", "cross"),
                           ("chr8_third ell batch", "cross_batch"),
                           ("chr8_third cross", "cross")):
            need(c.get(label, {}).get(key, 0) > 0,
                 f"rank {r['rank']}: the sharded {label} query never launched "
                 f"{key}")
        n_k9, n_q = c["chr8_third ell"].get("ell_flat", 0), r["runs"]["chr8_third ell"]
        need(n_k9 == n_q, f"rank {r['rank']}: {n_k9} K9 launches in {n_q} "
             "sharded ELL queries, want one each")
    for r in ranks:
        print(f"phase 6, rank {r['rank']} of {SHARDED_RANKS} over {r['backend']} "
              f"(torch {r['torch']}, mesh {r['mesh']}), {SHARDED_LABEL} "
              f"[{card}]: wide_p2e17 {r['wide_p2e17']}, chr8_third "
              f"{r['chr8_third']}, bench {r['bench']}; launches {r['launches']}; "
              f"{r['seconds']:.1f} s", flush=True)
        for label, row in r["times"].items():
            print(f"  rank {r['rank']} {label} [{SHARDED_LABEL}; {card}]: " + "; ".join(
                f"{k} wall {v['wall_us']:.2f} us, busy "
                + (f"{v['busy_us']:.2f} us" if v.get("busy_us") else "not measured")
                for k, v in row.items()), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 7: the port's examples (examples/torch/) on the card: each on its
# fixtures with --device cuda, byte for byte as its --device cpu run; the
# batch example in process at bench (K4); the object-API walk at unfused.
# ---------------------------------------------------------------------------

EXAMPLES_DIR = REPO / "examples" / "torch"
EXAMPLE_GFA = REPO / "examples" / "example.gfa"
EXAMPLE_DEPTH = ["1\t2", "2\t2", "3\t1", "4\t2"]
EXAMPLE_SUBSETS = 3  # batch_depth.py's subsets: the first path, all, every other


def _example_batch_depth_ok(out):
    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.flatgfa import parse_gfa_file
    from pollen_tpu_torch.ops.depth import run_seg_depth

    if out.count("# subset") != EXAMPLE_SUBSETS:
        return False
    # Subset 1 is all paths: its block is the plain depth -d table.
    g = parse_gfa_file(str(EXAMPLE_GFA))
    block = out.split("# subset ")[2].splitlines()[1:]
    return "\n".join(block) + "\n" == run_seg_depth(g, build_graph(g, "cuda"))


# What tests/test_examples.py asks of each example's counterpart.
EXAMPLE_CHECKS = {
    "depth": lambda out: out.splitlines() == ["#node.id\tdepth"] + EXAMPLE_DEPTH,
    "batch_depth": _example_batch_depth_ok,
    "gaf": lambda out: (out.splitlines()[:2] == ["foo", "AAGAAATTTTCT"]
                        and "(5, 8)" in out and "bar" in out),
    "matrix": lambda out: out.startswith("example.gaf 1 1 1 1"),
    "spec_depth": lambda out: out.splitlines()[1:] == EXAMPLE_DEPTH,
    "flash_example": lambda out: (
        "#path\tstart\tend\tmean.depth" in out
        and 0 <= out.find("#node.id\tdepth\tdepth.uniq") < out.index("#path")),
    "windows": lambda out: out.splitlines()[0].startswith("alpha\t0\t4\t"),
}


def example_command(name: str, device: str) -> list:
    """The command that runs one example on ``device`` from the repo root
    (spec_depth has no device: it reads GFA from stdin)."""
    if name == "flash_example":
        return ["flash-torch", "--device", device,
                str(EXAMPLES_DIR / "flash_example.sh")]
    if name == "windows":
        return ["sh", str(EXAMPLES_DIR / "windows.sh"), device]
    argv = [sys.executable, str(EXAMPLES_DIR / f"{name}.py")]
    return argv if name == "spec_depth" else argv + ["--device", device]


def phase_examples_fixtures(card: str) -> dict:
    """Every example as a subprocess on its fixtures, all started at once:
    its --device cuda stdout equal to its --device cpu stdout, byte for
    byte, and passing tests/test_examples.py's assertions. Returns each
    run's seconds from its start until it was collected."""
    from pollen_tpu_torch.scripts import script_env

    env = script_env()
    procs = {}
    try:
        for name in EXAMPLE_CHECKS:
            devices = ("cpu",) if name == "spec_depth" else ("cuda", "cpu")
            for device in devices:
                with open(EXAMPLE_GFA if name == "spec_depth" else os.devnull,
                          "rb") as stdin:
                    procs[name, device] = (time.perf_counter(), subprocess.Popen(
                        example_command(name, device), stdin=stdin,
                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True, cwd=REPO, env=env))
        outs, secs = {}, {}
        for key, (t0, proc) in procs.items():
            out, err = proc.communicate(timeout=300)
            secs[f"{key[0]} {key[1]}"] = time.perf_counter() - t0
            need(proc.returncode == 0,
                 f"example {key[0]} --device {key[1]} failed: {err[-2000:]}")
            outs[key] = out
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, check in EXAMPLE_CHECKS.items():
        out = outs[name, "cpu"]
        if name != "spec_depth":
            need(outs[name, "cuda"] == out,
                 f"example {name}: --device cuda prints other bytes than "
                 "--device cpu")
        need(check(out), f"example {name}: not the lines tests/test_examples"
             f".py expects: {out[:300]!r}")
    print(f"phase 7 (a): the 7 examples on their fixtures, --device cuda "
          f"equal to --device cpu byte for byte (spec_depth has no device) "
          f"and to tests/test_examples.py's lines; seconds from each run's "
          f"start until it was collected (all started at once) " + ", ".join(f"{k} {v:.2f}" for k, v in
                                         secs.items()) + f" [{card}]",
          flush=True)
    return secs


def load_example(name: str):
    """examples/torch/<name>.py as a module (its __main__ block unrun)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Clock:
    """Wraps functions (``mock.patch.object``) to log each call's seconds,
    and its arguments, under a label."""

    def __init__(self):
        self.calls = []

    def wrap(self, label, fn, sync=False):
        import torch

        def timed(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            self.calls.append((label, time.perf_counter() - t0, args))
            return out

        return timed

    def seconds(self, label) -> float:
        return sum(s for name, s, _ in self.calls if name == label)

    def args(self, label) -> list:
        return [a for name, _, a in self.calls if name == label]


def no_plain_versions(ran: list):
    """A context in which every kernel wrapper module's plain version
    (``*_plain``) records its name in ``ran`` and raises."""
    import contextlib

    from pollen_tpu_torch.kernels import (
        crossmat, crossprobe, ellscan, gatherb, runscan, segscan,
    )

    def refuse(name):
        def plain(*args, **kwargs):
            ran.append(name)
            raise SmokeError(f"the plain version {name} ran")
        return plain

    stack = contextlib.ExitStack()
    for mod in (crossmat, crossprobe, ellscan, gatherb, runscan, segscan):
        for attr in dir(mod):
            if attr.endswith("_plain") and callable(getattr(mod, attr)):
                stack.enter_context(mock.patch.object(
                    mod, attr, refuse(f"{mod.__name__}.{attr}")))
    return stack


def gfa_text_file(g, path: pathlib.Path):
    """``g`` with its paths' links as GFA text at ``path``, as phase 5
    prints it (``add_path_links``, ``text_arena``, the native emit)."""
    from pollen_tpu_torch import native

    linked, _, _ = add_path_links(g)
    need(native.emit_gfa_file_native(text_arena(linked), str(path)),
         f"{path.name}: the native file emit fell back")


def table_rows(text: str, cols: int):
    """The int rows of a TSV table's body (no header lines)."""
    import numpy as np

    return np.array(text.split(), np.int64).reshape(-1, cols)


def phase_example_batch(g, reference, gfa: pathlib.Path, tmp: pathlib.Path,
                        card: str) -> dict:
    """batch_depth.py's main in process on bench's GFA on the card, stdout
    to a file, under a launch count and with every plain version refused:
    its three tables equal ``reference`` on the masks it built, K4 ran,
    its masks were numpy; then the CUDA-event wall per call of its query
    and of the query's device part, at its Q and at Q = 32."""
    import numpy as np
    import torch

    from pollen_tpu_torch import device as device_mod
    from pollen_tpu_torch import flatgfa
    from pollen_tpu_torch.ops import depth as depth_op

    example = load_example("batch_depth")
    clock, ran = Clock(), []
    out_path = tmp / "batch_depth.out"
    real_batch = depth_op.seg_depth_with_uniq_batch
    with no_plain_versions(ran), \
            mock.patch.object(flatgfa, "parse_gfa_file", clock.wrap(
                "parse", flatgfa.parse_gfa_file)), \
            mock.patch.object(device_mod, "build_graph", clock.wrap(
                "ingest", device_mod.build_graph, sync=True)), \
            mock.patch.object(depth_op, "seg_depth_with_uniq_batch",
                              clock.wrap("query", real_batch, sync=True)), \
            open(out_path, "w") as f:
        reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(sys, "stdout", f):
            example.main(str(gfa), "cuda")
        f.flush()
        total = time.perf_counter() - t0
        counts = launch_counts()
    need(not ran, f"plain versions ran in the batch example: {ran}")
    need(counts["ell_splitn_batch"] > 0,
         f"the batch example at bench never launched K4: {counts}")
    (dg, masks), = clock.args("query")
    need(dg.device.type == "cuda", f"the example's graph is on {dg.device}")
    need(depth_op.batch_route(dg) == "ell",
         f"bench's batch plan routes {depth_op.batch_route(dg)!r}, not ell")
    need(isinstance(masks, np.ndarray) and masks.dtype == bool,
         f"the example passed {type(masks).__name__} masks, not numpy bool")
    names = [b.decode() for b in g.path_names()]
    subsets = [names[:1], names, names[::2]]
    want_masks = np.stack([depth_op.path_mask_for(g, s) for s in subsets])
    need(np.array_equal(masks, want_masks), "the example's masks differ")
    text = out_path.read_text()
    blocks = text.split("# subset ")[1:]
    need(len(blocks) == EXAMPLE_SUBSETS, f"{len(blocks)} subset tables")
    n = g.num_segments
    for q, block in enumerate(blocks):
        head, header, body = block.split("\n", 2)
        need(head == f"{q}: {','.join(subsets[q])}"
             and header == "#node.id\tdepth\tdepth.uniq",
             f"subset {q}: headers {head[:60]!r}, {header!r}")
        rows = table_rows(body, 3)
        d_ref, u_ref = reference(masks[q])
        need(rows.shape[0] == n and np.array_equal(rows[:, 0], g.seg_name)
             and np.array_equal(rows[:, 1], d_ref)
             and np.array_equal(rows[:, 2], u_ref),
             f"subset {q}: the example's table differs from NumpyReference")
    # The example's call, then its device part alone (the per-class parts
    # on the card, no host compose), each also at phase 3's Q = 32 batch.
    masks32 = batch_masks(g.num_paths, np.random.default_rng(8))
    walls = {}
    with no_plain_versions(ran):
        for q, m in ((masks.shape[0], masks), (32, masks32)):
            mt = torch.from_numpy(m).cuda()
            walls[q] = (
                cuda_ms(lambda: real_batch(dg, m)) * 1e3,
                cuda_ms(lambda: depth_op.seg_depth_with_uniq_ell_batch_parts(
                    dg, mt)) * 1e3,
            )
    need(not ran, f"plain versions ran in the timed query: {ran}")
    q3 = masks.shape[0]
    row = dict(text_bytes=gfa.stat().st_size, out_bytes=len(text),
               end_to_end_s=total, parse_s=clock.seconds("parse"),
               ingest_s=clock.seconds("ingest"),
               query_first_s=clock.seconds("query"),
               query_wall_us=walls[q3][0], per_query_us=walls[q3][0] / q3,
               parts_wall_us=walls[q3][1], q32_wall_us=walls[32][0],
               q32_per_query_us=walls[32][0] / 32, q32_parts_wall_us=walls[32][1],
               launches={k: v for k, v in counts.items() if v})
    row["text_s"] = total - row["parse_s"] - row["ingest_s"] - row[
        "query_first_s"]
    print(f"phase 7 (b): batch_depth.py at bench ({row['text_bytes']} bytes "
          f"of GFA, {n} segments, Q = {masks.shape[0]} numpy masks): "
          f"{total:.3f} s end to end (parse {row['parse_s']:.3f}, ingest "
          f"{row['ingest_s']:.3f}, first query {row['query_first_s']:.3f}, "
          f"text {row['text_s']:.3f}); the query {row['query_wall_us']:.2f} "
          f"us wall a call, {row['per_query_us']:.2f} a query, its device "
          f"part (the ELL parts, no host compose) {row['parts_wall_us']:.2f}; "
          f"at Q = 32 {row['q32_wall_us']:.2f} a call, "
          f"{row['q32_per_query_us']:.2f} a query, device part "
          f"{row['q32_parts_wall_us']:.2f}; three tables "
          f"equal NumpyReference; launches {row['launches']}; no plain "
          f"version [{card}]", flush=True)
    return row


def phase_example_walk(g, reference, gfa: pathlib.Path, tmp: pathlib.Path,
                       card: str) -> dict:
    """depth.py's main in process on unfused's GFA on the card: its walk
    over every step (checked inside main against seg_depth_with_uniq on
    the card) and its printed table against ``reference`` (all paths)."""
    import numpy as np

    import pollen_tpu_torch
    from pollen_tpu_torch import device as device_mod

    example = load_example("depth")
    clock = Clock()
    out_path = tmp / "depth.out"
    with mock.patch.object(pollen_tpu_torch, "parse", clock.wrap(
                "parse", pollen_tpu_torch.parse)), \
            mock.patch.object(example, "depth_by_walking", clock.wrap(
                "walk", example.depth_by_walking)), \
            mock.patch.object(device_mod, "build_graph", clock.wrap(
                "ingest", device_mod.build_graph, sync=True)), \
            open(out_path, "w") as f:
        t0 = time.perf_counter()
        with mock.patch.object(sys, "stdout", f):
            example.main(str(gfa), "cuda")
        f.flush()
        total = time.perf_counter() - t0
    (arrays, dev), = [a for a in clock.args("ingest")]
    need(str(dev) == "cuda", f"the walk example's query ran on {dev}")
    header, body = out_path.read_text().split("\n", 1)
    rows = table_rows(body, 2)
    d_ref, _ = reference(np.ones(g.num_paths, bool))
    need(header == "#node.id\tdepth" and rows.shape[0] == g.num_segments
         and np.array_equal(rows[:, 0], g.seg_name)
         and np.array_equal(rows[:, 1], d_ref),
         "the walk example's table differs from NumpyReference")
    row = dict(steps=g.num_steps, end_to_end_s=total,
               parse_s=clock.seconds("parse"), walk_s=clock.seconds("walk"),
               ingest_and_query_s=total - clock.seconds("parse")
               - clock.seconds("walk"))
    print(f"phase 7 (c): depth.py at unfused ({gfa.stat().st_size} bytes of "
          f"GFA, {g.num_steps} steps): {total:.3f} s end to end; the object-"
          f"API walk {row['walk_s']:.3f} s ({row['walk_s'] / g.num_steps * 1e9:.1f} "
          f"ns a step), parse {row['parse_s']:.3f}, ingest, the device query "
          f"and the table {row['ingest_and_query_s']:.3f}; the walk equals "
          f"seg_depth_with_uniq on the card and the table NumpyReference "
          f"[{card}]", flush=True)
    return row


def phase_examples(graphs: dict, card: str) -> dict:
    """Phase 7: the examples on their fixtures (cuda against cpu), the
    batch example at bench, the walk at unfused. ``graphs`` needs
    ``bench`` and ``unfused`` as ``(g, dg or None, NumpyReference or
    None)``; a missing reference is built from the graph on the card."""
    from pollen_tpu_torch import native
    from pollen_tpu_torch.device import build_graph

    need(native.native_available(),
         f"the native library did not build: {native.build_error}")
    out = {"fixtures_s": phase_examples_fixtures(card)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for name, phase in (("bench", phase_example_batch),
                            ("unfused", phase_example_walk)):
            g, dg, reference = graphs[name]
            if reference is None:
                reference = NumpyReference(dg or build_graph(g, "cuda"))
            gfa = tmp / f"{name}.gfa"
            gfa_text_file(g, gfa)
            out[name] = phase(g, reference, gfa, tmp, card)
            gfa.unlink()
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
    phase_kernels_tier(errs)
    phase_kernels_flat(errs)
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
        phase_goldens_commands(pathlib.Path(tmp))
        stamp("graph commands on the fixtures done")
        phase_goldens_gaf(pathlib.Path(tmp))
        stamp("the rest of the CLI on the fixtures done")
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
    device_ops = phase_graph_ops(graphs, card)
    stamp("graph-command ops at scale done")
    kept: dict = {}
    device_ops += phase_gaf_ops(graphs, card, kept)
    stamp("the rest of the CLI at scale done")
    api = phase_api_shell(graphs, kept.pop("gaf"), card)
    for name, key, path in (("ell_splitn (K1)", "ell_splitn", "api queries"),
                            ("cross (K2)", "cross", "entry")):
        need(api["launches"][path][key] > 0,
             f"{name} was never launched by the {path}")
    stamp("the library API, the shell and the entry at chr8_third done")
    t5 = time.perf_counter()
    phase5 = phase_native_spec_probes(graphs, card)
    phase5["seconds"] = time.perf_counter() - t5
    stamp("native host code, the spec oracle, the permuted query and the "
          "probes done")
    t6 = time.perf_counter()
    sharded = phase_sharded(graphs, card)
    sharded["seconds"] = time.perf_counter() - t6
    timed = sharded["two_ranks"][SHARDED_TIMED_RANK]
    timing.update(timed["kernel_times"])
    for name in SHARDED_ROWS:
        key = KERNELS[name][2]
        errs.max[name] = timed["kernel_errs"][name]
        runs = [sharded["one_rank"]["launches"]]
        runs += [r["launches"] for r in sharded["two_ranks"]]
        launches[name] = sum(c.get(key, 0) for run in runs for c in run.values())
        need(launches[name] > 0, f"{name} was never launched by phase 6")
    stamp("phase 6: the sharded path (one rank over NCCL; two ranks on the "
          "card over gloo) done")
    stamp("phase 7: the examples (examples/torch/) start")
    t7 = time.perf_counter()
    examples = phase_examples(graphs, card)
    examples["seconds"] = time.perf_counter() - t7
    launches["ell_splitn_batch (K4)"] += examples["bench"]["launches"][
        KERNELS["ell_splitn_batch (K4)"][2]]
    stamp("phase 7: the examples on their fixtures (cuda against cpu), the "
          "batch example at bench and the walk at unfused done")
    rows = [
        dict(name=name, route="cuda", source=src, replaces=replaces,
             launches=launches[name], max_abs_err=errs.max[name],
             **timing[name])
        for name, (src, replaces, _) in KERNELS.items()
    ]
    stamp("total")
    print(json.dumps({"device_ops": device_ops}))
    print(json.dumps({"api_shell": api}))
    print(json.dumps({"native_spec_probes": phase5}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"examples": examples}))
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
