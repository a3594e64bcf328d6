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
   in both layouts, at Q = 1, 5, 32 and 40 seeded masks;
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
and a head carry (phase 1); ``depth -d -s`` (route "scan") and
``depth -d -S`` (route "runs") goldens and a ``serve`` request of each
under POLLEN_CROSS_BUDGET_MB=0 (phase 2); and two synthetic graphs,
wide_p2e17 (2^17 paths, route "scan") and bench_runs (route "runs"),
8 masks and a Q = 32 batch each, against plain and numpy (phase 3).

Launch counts are set to 0 right before each main path (the single
query: phase 2's single-query requests and phase 3's queries; the
batch: phase 2's ``-S`` requests and phase 3's batches; the scan
family: its phase 2 requests and phase 3 queries and batches) and read
right after it: every kernel must have been launched by its path.
Exits nonzero at the first failed check. The second-to-last line is one
JSON object with each kernel's launches, error, time, bound and library
call time; the last is ``{"ok": true, "device": {...}}``.
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
}
# The kernels of each main path: the single query, the batch, the scan
# family (single queries and batches past the ELL and matrix budgets).
SINGLE_PATH = ("ell_splitn (K1)", "cross (K2)", "ell_tier (K3)")
BATCH_PATH = ("ell_splitn_batch (K4)", "cross_batch (K5)")
SCAN_PATH = ("seg_scan (K6)", "boundary (K7)", "run_scan (K8)")
# Batch sizes of phase 1 (40: over the kernels' 32-query chunk) and of
# the batch timing.
KERNEL_QS = (1, 5, 32, 40)
TIMING_QS = (1, 8, 16, 32)
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
        crossmat, ellscan, gatherb, runscan, segscan,
    )

    return [m.launches for m in (ellscan, crossmat, segscan, gatherb, runscan)]


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


def phase_timing(graphs: dict, batch: dict, card: str) -> dict:
    """Phase 3 (timing): one query and each kernel, kernel vs plain."""
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
    tiers = [t for t in (dg.cross_ell, dg.cross_ell2, dg.cross_ell3) if t.numel()]
    ks = [k for k in (dg.ell_k, dg.ell_k2, dg.ell_k3) if k]
    args = (tiers, dg.ell_heavy, m, ks)
    p16 = bool(dg.ell_pack16)
    slots = sum(t.numel() for t in tiers) * (2 if p16 else 1)
    cols = sum(t.numel() // k for t, k in zip(tiers, ks)) + dg.ell_heavy.shape[1]
    tier_bytes = 4 * sum(t.numel() for t in tiers) + dg.ell_heavy.numel()
    cells = 2 * dg.ell_heavy.numel()  # nibble: two paths a byte
    times["ell_splitn (K1)"] = (
        lambda: ell.masked_ell_splitn_depth(*args, pack16=p16),
        lambda: ell.masked_ell_splitn_depth_plain(*args, pack16=p16),
        "bench",
        bound(tier_bytes + dg.num_paths + 8 * cols, core_ops=4 * slots,
              tensor_ops=4 * cells),
        None,
    )
    _, dgu, _ = graphs["unfused"]
    mu = torch.from_numpy(rng.random(dgu.num_paths) < 0.5).cuda()
    mpu = torch.zeros(dgu.ell_heavy.shape[0] * 2, dtype=torch.int32,
                      device="cuda")
    mpu[: dgu.num_paths] = mu.to(torch.int32)
    hu = dgu.ell_heavy
    # The nearest one-call form of K2: a float32 product of the folded
    # mask against a copy of A unpacked ahead of time (depth only).
    au = cm.unpack_cross(hu).float()
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
    times["ell_tier (K3)"] = (
        lambda: ell.masked_ell_depth_tall(tu, mu, dgu.ell_k, p16u),
        lambda: ell.masked_ell_depth_tall_plain(tu, mu, dgu.ell_k, p16u),
        "unfused tier 1",
        bound(4 * tu.numel() + dgu.num_paths + 8 * (tu.numel() // dgu.ell_k),
              core_ops=4 * tu.numel() * (2 if p16u else 1)),
        None,
    )
    m32 = torch.from_numpy(batch_masks(dg.num_paths, rng)).cuda()
    times["ell_splitn_batch (K4)"] = (
        lambda: ell.masked_ell_splitn_depth_batch(
            tiers, dg.ell_heavy, m32, ks, pack16=p16
        ),
        lambda: ell.masked_ell_splitn_depth_batch_plain(
            tiers, dg.ell_heavy, m32, ks, pack16=p16
        ),
        "bench, Q=32",
        bound(tier_bytes + 32 * dg.num_paths + 8 * 32 * cols,
              core_ops=4 * slots * 32, tensor_ops=4 * cells * 32),
        None,
    )
    dgc = batch["bench_cross"][1]
    nib = dgc.cross_nibble
    mpc = cm.pad_mask(m32, dgc.cross_matrix.shape[0] * (2 if nib else 1))
    ac = dgc.cross_matrix
    a_c = (cm.unpack_cross(ac) if nib else ac.to(torch.int32)).float()
    fm32 = (cm.fold_mask(mpc) if nib else mpc).float()
    times["cross_batch (K5)"] = (
        lambda: cm.batched_cross_depth(ac, m32, nibble=nib),
        lambda: cm.batched_cross_depth_plain(ac, mpc, nibble=nib),
        f"bench crossing matrix {tuple(ac.shape)}, Q=32",
        bound(ac.numel() + 32 * dgc.num_paths + 8 * 32 * ac.shape[1],
              tensor_ops=4 * 32 * ac.numel() * (2 if nib else 1)),
        lambda: torch.matmul(fm32, a_c),
    )
    return time_kernels(times)


def time_kernels(times: dict) -> dict:
    """Each kernel against its plain version (runs plain, kernel,
    kernel, plain) and its library call, CUDA events; the profiler's
    device time per call is printed beside."""
    import torch

    out = {}
    for name, (kern, plain, where, bnd, library) in times.items():
        got, want = kern(), plain()
        for a, b in zip(got if isinstance(got, tuple) else [got], want):
            need((a is None and b is None) or torch.equal(a, b),
                 f"{name} at {where}: kernel != plain")
        out[name] = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                     cuda_ms(plain), where, bnd,
                     None if library is None else cuda_ms(library))
        print(f"{name} at {where}: kernel call, "
              f"{describe_profile(device_profile(kern))}; plain call, "
              f"{describe_profile(device_profile(plain, reps=10))}", flush=True)
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
    torch.cuda.synchronize()
    print("phase 1 (scan family): K6, K7, K8 equal their plain versions on "
          f"8 fixtures and P = {', '.join(map(str, SCAN_PS))} (1-3 scan "
          "blocks), a group across three blocks and of 2^23 steps, head "
          "carry 0-2; 4 masks each (tolerance 0: exact int32)", flush=True)


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


def phase_scan_timing(scan: dict, card: str) -> dict:
    """Phase 3 (scan timing): one routed query and the runs batch at
    Q = 1 and 32, kernels against plain (CUDA-event wall, profiler
    busy); returns K6-K8's kernel timings for the JSON line."""
    import numpy as np
    import torch

    from pollen_tpu_torch.kernels import gatherb, runscan, segscan
    from pollen_tpu_torch.ops import depth as depth_op

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
    ones = torch.ones(n, dtype=torch.int32, device="cuda")
    times["seg_scan (K6)"] = (
        lambda: segscan.masked_depth_cumsums(path, rs, mw),
        lambda: segscan.masked_depth_cumsums_plain(path, rs, mw),
        f"wide_p2e17, {n} padded steps",
        bound(16 * n + dgw.num_paths, core_ops=6 * n),
        lambda: torch.cumsum(ones, 0, dtype=torch.int32),
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
    _, dgr, _ = scan["bench_runs"]
    mr = torch.from_numpy(rng.random(dgr.num_paths) < 0.5).cuda()
    r = dgr.run_path.shape[0]
    ones_r = torch.ones(r, dtype=torch.int32, device="cuda")
    times["run_scan (K8)"] = (
        lambda: runscan.masked_run_cumsums(dgr.run_path, dgr.run_count, mr),
        lambda: runscan.masked_run_cumsums_plain(dgr.run_path, dgr.run_count, mr),
        f"bench_runs, {r} padded runs",
        bound(16 * r + dgr.num_paths, core_ops=4 * r),
        lambda: torch.cumsum(ones_r, 0, dtype=torch.int32),
    )
    return time_kernels(times)


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

    errs = Errors()
    phase_kernels(errs)
    phase_kernels_scan(errs)
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
    print(f"main-path launches: single query {single}; batch {batched}; "
          f"scan family {scanned}", flush=True)
    launches = {}
    for names, counts in ((SINGLE_PATH, single), (BATCH_PATH, batched),
                          (SCAN_PATH, scanned)):
        for name in names:
            launches[name] = counts[KERNELS[name][2]]
            need(launches[name] > 0,
                 f"{name} was never launched by its main path")

    timing = phase_timing(graphs, batch, card)
    stamp("single-query and kernel timing done")
    phase_batch_timing(batch, card)
    stamp("batch timing done")
    timing.update(phase_scan_timing(scan, card))
    stamp("scan-family timing done")
    rows = []
    for name, (src, replaces, _) in KERNELS.items():
        p1, k1, k2, p2, where, (bound_ms, bound_by), lib_ms = timing[name]
        ms, plain_ms = min(k1, k2), min(p1, p2)
        lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.2f} us"
        print(f"{name} at {where} [{card}]: kernel {ms * 1e3:.2f} us, "
              f"plain {plain_ms * 1e3:.2f} us (runs plain, kernel, kernel, "
              f"plain: {p1 * 1e3:.2f} {k1 * 1e3:.2f} {k2 * 1e3:.2f} "
              f"{p2 * 1e3:.2f} us); bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}); library call {lib}", flush=True)
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=errs.max[name],
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms,
        ))
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
