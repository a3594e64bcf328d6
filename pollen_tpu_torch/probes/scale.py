"""The chr8-shaped scale run: the port's ingest, tier planner and masked
depth queries on a graph the size of a real chromosome, every answer
checked exactly against numpy.

The port's counterpart of the reference's gated ``tests/test_scale.py``
(``test_chr8_shaped_synthetic``): HPRC chr8's scale statistics, ~10^8
path steps over 2^22 segments and 96 haplotype paths, Zipf-tailed
crossing counts (``synth.synth_graph``, seed 8). In order:

1. ingest (``build_graph``), timed, with the index's bytes;
2. the planner's output: the four ELL classes partition at most the
   segments, and every tier's slots (tall 32-bit or pack16 words,
   decoded) hold exactly its segments' (path, count) runs, as numpy
   counts them;
3. the routed single query (``masked_seg_depth``) on the reference's
   mask (``default_rng(4)``, one bit a path): depth equal to a numpy
   bincount of the selected steps, uniq to a numpy count of distinct
   (segment, path) pairs;
4. the ELL route's plain form (``seg_depth_with_uniq_ell(plain=True)``);
5. the scan family on the same resident graph: the segment scan (K6)
   and the run scan (K8), each followed by the boundary stage (K7),
   against their plain forms and numpy; on the card each is called
   ``REPEATS`` times back to back, its cumsums held against the plain
   cumsums and its answers against numpy on the device, with no host
   round trip between calls;
6. a batch of ``BATCH_Q`` masks (``seg_depth_with_uniq_batch``), equal
   to numpy row by row;
7. on the card, each kernel's device µs per call (a replayed CUDA graph
   of back-to-back calls, ``timing.replay_us``) beside its byte bound.

Each stage prints one line (host seconds, kernel launches, device µs
where a kernel ran, peak device memory); the last line is one JSON
object with every figure. No stage catches a failure: a difference
raises ``ScaleCheckError`` and the run exits non-zero.

    python -m pollen_tpu_torch.probes.scale                 # 10^8 steps, cuda
    python -m pollen_tpu_torch.probes.scale --steps 8000000 --device cpu

``--steps`` defaults to ``POLLEN_CHR8_STEPS`` or 10^8. The device is the
card unless ``--device cpu`` is given; with no card, ``cuda`` is an
error, never a CPU run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import (
    TENSOR_FIELDS,
    TorchGraph,
    build_graph,
    ell_tiers,
    resolve_device,
)
from ..flatgfa import GraphArrays
from ..kernels import crossmat as _cm
from ..kernels import ellscan as _ell
from ..kernels import gatherb as _gb
from ..kernels import runscan as _rs
from ..kernels import segscan as _ss
from ..ops import depth as depth_op
from ..synth import synth_graph
from .timing import HBM_BPS, replay_us

CHR8_STEPS = 10**8
CHR8_SEGS = 2**22
CHR8_PATHS = 96
SEED = 8  # the reference bench's synthesis seed
REPEATS = 20  # back-to-back calls of each scan on the card
BATCH_Q = 32

_COUNTERS = (_ell.launches, _cm.launches, _ss.launches, _rs.launches,
             _gb.launches)


class ScaleCheckError(AssertionError):
    """An answer of the port differs from numpy or from its plain form,
    or a planner limit does not hold."""


def need(ok: bool, what: str) -> None:
    if not ok:
        raise ScaleCheckError(what)


def routed_mask(n_paths: int) -> np.ndarray:
    """The reference test's mask: ``default_rng(4)``, one bit a path."""
    return np.random.default_rng(4).integers(0, 2, n_paths).astype(bool)


def batch_masks(n_paths: int, q: int = BATCH_Q) -> np.ndarray:
    """(q, n_paths) bool: all paths, none, then seeded rows."""
    rng = np.random.default_rng(5)
    masks = rng.random((q, n_paths)) < rng.random((q, 1))
    masks[0], masks[1] = True, False
    return masks


class NumpyTruth:
    """Depth and uniq straight from the arena's step list: each path's
    distinct segments and their step counts (``np.unique``), summed over
    a mask's paths by ``np.bincount``; independent of the port's index."""

    def __init__(self, g: GraphArrays):
        self.n = g.num_segments
        self.seg = (g.steps >> 1).astype(np.int64)
        self.bounds = g.path_steps.astype(np.int64)
        self.uniq_segs, self.counts = [], []
        for lo, hi in self.bounds:
            u, c = np.unique(self.seg[lo:hi], return_counts=True)
            self.uniq_segs.append(u)
            self.counts.append(c)
        self.n_paths = len(self.counts)

    def selected_depth(self, mask: np.ndarray) -> np.ndarray:
        """The reference test's form: a bincount of the selected steps."""
        sel = np.zeros(self.seg.shape[0], bool)
        for p in np.flatnonzero(mask):
            sel[self.bounds[p, 0] : self.bounds[p, 1]] = True
        return np.bincount(self.seg[sel], minlength=self.n)

    def runs(self):
        """(keys ``segment * n_paths + path``, step counts) of every
        (segment, path) run, ordered by key."""
        keys = np.concatenate([u * self.n_paths + p
                               for p, u in enumerate(self.uniq_segs)])
        counts = np.concatenate(self.counts)
        order = np.argsort(keys, kind="stable")
        return keys[order], counts[order]

    def answer(self, mask: np.ndarray):
        """(depth, uniq) int64[N] for one mask, from the per-path
        tables."""
        paths = np.flatnonzero(mask)
        if not paths.size:
            return np.zeros(self.n, np.int64), np.zeros(self.n, np.int64)
        segs = np.concatenate([self.uniq_segs[p] for p in paths])
        counts = np.concatenate([self.counts[p] for p in paths])
        depth = np.bincount(segs, weights=counts, minlength=self.n)
        uniq = np.bincount(segs, minlength=self.n)
        return depth.astype(np.int64), uniq.astype(np.int64)


def _same(got, want, what: str) -> None:
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    need(got.shape == want.shape, f"{what}: shape {got.shape}, want {want.shape}")
    diff = np.flatnonzero(got != want)
    need(not diff.size, f"{what}: {diff.size} of {want.size} differ, first "
         f"at {int(diff[0]) if diff.size else -1}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_launches() -> None:
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0


def _launches() -> Dict[str, int]:
    return {k: v for c in _COUNTERS for k, v in c.items() if v}


def _peak(device: torch.device) -> Optional[int]:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def index_bytes(dg: TorchGraph) -> int:
    return sum(getattr(dg, f).numel() * getattr(dg, f).element_size()
               for f in TENSOR_FIELDS)


def _slot_runs(slots: np.ndarray, segs: np.ndarray):
    """(segment, path, count) int64 of each used slot of a tier's
    decoded int32[K, columns] slots, ``segs`` naming each column's
    segment."""
    k_i, c_i = np.nonzero(slots)
    v = slots[k_i, c_i].astype(np.int64)
    return segs[c_i].astype(np.int64), v >> _ell.COUNT_BITS, v & _ell.COUNT_MAX


def check_plan(dg: TorchGraph, truth: NumpyTruth) -> dict:
    """The planner's output at this size, as ``test_scale.py`` checks it
    and further: the classes partition at most N; and every tier's slots,
    decoded (from pack16 words where the index is pack16), hold exactly
    the runs of the tier's segments, each (path, count) equal to the
    numpy tables' and once, and nothing past the tier's columns. A path
    id or count that overflowed its 16 (pack16: 8) bits would decode to
    another run."""
    classes = (dg.ell_num_light, dg.ell_num_mid, dg.ell_num_mid2,
               dg.ell_num_heavy)
    plan = dict(classes=classes, ks=(dg.ell_k, dg.ell_k2, dg.ell_k3),
                pack16=bool(dg.ell_pack16),
                heavy_cols=int(dg.ell_heavy.shape[1]) if dg.ell_heavy.numel() else 0,
                tier_slots=[])
    if not dg.cross_ell.numel():
        return plan
    n, p = dg.num_segments, truth.n_paths
    need(sum(classes) <= n, f"ELL classes {classes} exceed {n} segments")
    order = (dg.ell_order.cpu().numpy() if dg.ell_order.numel()
             else np.arange(n, dtype=np.int32))
    want_keys, want_counts = truth.runs()
    lo = 0
    for i, ((tall, k), cols) in enumerate(zip(ell_tiers(dg), classes), 1):
        slots = _ell.unfold_ell_tall(tall, k)
        if dg.ell_pack16:
            slots = _ell.unpair_ell16(slots)
        slots = slots.cpu().numpy()
        need(not slots[:, cols:].any(), f"tier {i}: a slot past its {cols} columns")
        segs = order[lo : lo + cols]
        seg, path, count = _slot_runs(slots[:, :cols], segs)
        need(not (path >= p).any(), f"tier {i}: a slot names a path past {p}")
        keys = seg * p + path
        by_key = np.argsort(keys, kind="stable")
        keys, counts = keys[by_key], count[by_key]
        in_tier = np.zeros(n, bool)
        in_tier[segs] = True
        sel = in_tier[want_keys // p]
        need(np.array_equal(keys, want_keys[sel]),
             f"tier {i}: its slots' (segment, path) pairs are not its runs")
        need(np.array_equal(counts, want_counts[sel]),
             f"tier {i}: a slot's count differs from its run's")
        plan["tier_slots"].append(int(keys.size))
        lo += cols
    return plan


class Run:
    """One scale run's stages: each prints its line and keeps its
    figures in ``stages``; with ``keep``, its answers in ``answers``."""

    def __init__(self, device: torch.device, keep: bool):
        self.device, self.keep = device, keep
        self.stages: Dict[str, dict] = {}
        self.answers: Dict[str, object] = {}

    def stage(self, name: str, fn: Callable, **fields):
        """Run ``fn`` as stage ``name``: host seconds (synchronised),
        kernel launches and peak device memory of the stage."""
        _sync(self.device)
        _reset_launches()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        out = fn()
        _sync(self.device)
        rec = dict(seconds=time.perf_counter() - t0, launches=_launches(),
                   peak_bytes=_peak(self.device), **fields)
        self.stages[name] = rec
        print(f"stage {name}: " + ", ".join(
            f"{k} {v}" for k, v in rec.items() if v is not None), flush=True)
        return out

    def note(self, name: str, **fields) -> None:
        self.stages[name].update(fields)
        print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in fields.items()),
              flush=True)

    def kept(self, name: str, value) -> None:
        if self.keep:
            self.answers[name] = value


def _check_scan(run: Run, name: str, dg: TorchGraph, m: torch.Tensor,
                scan: Callable, scan_plain: Callable, args: tuple,
                bounds: torch.Tensor, want: tuple, repeats: int) -> None:
    """One scan route: the kernel's cumsums against the plain cumsums,
    the boundary stage's answer against numpy and against the plain
    boundary stage; ``repeats`` calls back to back, compared on the
    device (a count of differing elements, read once at the end)."""
    plain_cs = scan_plain(*args)
    plain = _gb.gather_boundary_diff_plain(plain_cs, bounds)
    want_t = tuple(torch.from_numpy(w.astype(np.int32)).to(run.device)
                   for w in want)
    for w, p, what in zip(want_t, plain, ("depth", "uniq")):
        need(torch.equal(p, w), f"{name} plain {what} differs from numpy")
    bad = torch.zeros((), dtype=torch.int64, device=run.device)
    first = None
    for _ in range(repeats):
        cs = scan(*args)
        for c, p in zip(cs, plain_cs):
            bad += (c != p).sum()
        out = _gb.gather_boundary_diff(cs, bounds)
        for o, w in zip(out, want_t):
            bad += (o != w).sum()
        first = out if first is None else first
    need(int(bad) == 0, f"{name}: {int(bad)} elements differ over {repeats} calls")
    run.kept(name, tuple(x.cpu().numpy() for x in first))
    run.kept(name + "_plain", tuple(x.cpu().numpy() for x in plain))


def _kernel_times(dg: TorchGraph, m: torch.Tensor, ms: torch.Tensor,
                  launched: Dict[str, int]) -> Dict[str, dict]:
    """Device µs per call of each kernel this run's stages launched, at
    the shapes they gave it, beside its byte bound (each input read
    once, each output written once; K7 reads two cumsum values a
    bound)."""
    rows = {}

    def row(name, fn, nbytes):
        us = replay_us(fn)
        bound_us = nbytes / HBM_BPS * 1e6
        rows[name] = dict(device_us=us, bound_us=bound_us,
                          share_of_bound=bound_us / us)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    tiers = ell_tiers(dg) if dg.cross_ell.numel() else []
    talls, ks = [t for t, _ in tiers], [k for _, k in tiers]
    p16 = bool(dg.ell_pack16)
    if launched.get("ell_splitn"):
        def k1():
            return _ell.masked_ell_splitn_depth(talls, dg.ell_heavy, m, ks,
                                                pack16=p16)
        row("K1 ell_splitn", k1, nbytes([*talls, dg.ell_heavy, m, *k1()]))
    if launched.get("ell_splitn_batch"):
        def k4():
            return _ell.masked_ell_splitn_depth_batch(talls, dg.ell_heavy, ms,
                                                      ks, pack16=p16)
        row(f"K4 ell_splitn_batch (Q = {ms.shape[0]})", k4,
            nbytes([*talls, dg.ell_heavy, ms, *k4()]))
    scan_args = (dg.step_path_sorted, dg.run_start, m)
    row("K6 seg_scan", lambda: _ss.masked_depth_cumsums(*scan_args),
        4 * 4 * dg.step_path_sorted.shape[0])
    csums = _ss.masked_depth_cumsums(*scan_args)
    n = dg.num_segments
    row("K7 boundary", lambda: _gb.gather_boundary_diff(csums, dg.seg_bounds),
        4 * (n + 1) + 2 * 4 * (n + 1) + 2 * 4 * n)
    del csums
    run_args = (dg.run_path, dg.run_count, m)
    row("K8 run_scan", lambda: _rs.masked_run_cumsums(*run_args),
        4 * 4 * dg.run_path.shape[0])
    return rows


def run_checks(n_steps: int, n_segs: int = CHR8_SEGS,
               n_paths: int = CHR8_PATHS, device="cuda", *,
               keep: bool = False) -> Run:
    """Every stage of the scale run on ``device`` (see the module's
    docstring); raises ``ScaleCheckError`` at the first difference.
    ``keep`` keeps each stage's answers (host arrays) in
    ``Run.answers``: "routed", "ell_plain", "scan", "scan_plain",
    "runs", "runs_plain" as (depth, uniq), "batch" as (Q, N) pairs."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    run = Run(device, keep)
    print(f"chr8-shaped scale run: S={n_steps} N={n_segs} P={n_paths} "
           f"seed {SEED} on {device}"
           + (f" ({torch.cuda.get_device_name(device)})" if on_card else ""),
           flush=True)

    g = run.stage("synth", lambda: synth_graph(n_steps, n_segs, n_paths, SEED))
    dg = run.stage("ingest", lambda: build_graph(g, device))
    run.note("ingest", index_bytes=index_bytes(dg),
             padded_steps=dg.padded_steps, runs=int(dg.run_path.shape[0]))
    truth = run.stage("numpy", lambda: NumpyTruth(g))
    plan = run.stage("plan", lambda: check_plan(dg, truth))
    run.note("plan", **plan)
    run.kept("plan", plan)

    mask = routed_mask(n_paths)
    want = truth.answer(mask)
    _same(want[0], truth.selected_depth(mask), "numpy tables against bincount")
    route = depth_op.masked_route_fn(dg)[0]
    got = run.stage("routed", lambda: depth_op.masked_seg_depth(dg, mask),
                    route=route)
    _same(got[0], want[0], f"routed ({route}) depth")
    _same(got[1], want[1], f"routed ({route}) uniq")
    need(not on_card or bool(run.stages["routed"]["launches"]),
         "the routed query launched no kernel")
    run.kept("routed", got)

    if dg.cross_ell.numel():
        got = run.stage("ell_plain", lambda: depth_op.seg_depth_with_uniq_ell(
            dg, mask, plain=True))
        _same(got[0], want[0], "ELL plain depth")
        _same(got[1], want[1], "ELL plain uniq")
        run.kept("ell_plain", tuple(x.numpy() for x in got))
    else:
        print("stage ell_plain: no ELL index at this size", flush=True)

    m = torch.as_tensor(mask, device=device).to(torch.int32)
    repeats = REPEATS if on_card else 1
    for name, scan, plain, args, bounds, kernels in (
        ("scan", _ss.masked_depth_cumsums, _ss.masked_depth_cumsums_plain,
         (dg.step_path_sorted, dg.run_start, m), dg.seg_bounds,
         ("seg_scan", "boundary")),
        ("runs", _rs.masked_run_cumsums, _rs.masked_run_cumsums_plain,
         (dg.run_path, dg.run_count, m), dg.run_seg_bounds,
         ("run_scan", "boundary")),
    ):
        run.stage(name, lambda: _check_scan(
            run, name, dg, m, scan, plain, args, bounds, want, repeats),
            repeats=repeats)
        if on_card:
            launched = run.stages[name]["launches"]
            need(all(launched.get(k, 0) >= repeats for k in kernels),
                 f"{name}: launches {launched}, want {kernels} x {repeats}")

    masks = batch_masks(n_paths)
    batch_route = depth_op.batch_route(dg)
    got = run.stage("batch", lambda: depth_op.seg_depth_with_uniq_batch(
        dg, masks), route=batch_route, q=masks.shape[0])
    for q in range(masks.shape[0]):
        want_q = truth.answer(masks[q])
        _same(got[0][q], want_q[0], f"batch row {q} depth")
        _same(got[1][q], want_q[1], f"batch row {q} uniq")
    need(int(got[0][0].sum()) == n_steps, "the all-paths row does not sum to S")
    need(not on_card or bool(run.stages["batch"]["launches"]),
         "the batch launched no kernel")
    run.kept("batch", got)

    if on_card:
        launched = {**run.stages["routed"]["launches"],
                    **run.stages["batch"]["launches"]}
        ms = torch.as_tensor(masks, device=device).to(torch.int32)
        rows = run.stage("kernels", lambda: _kernel_times(dg, m, ms, launched))
        for name, r in rows.items():
            print(f"  {name}: {r['device_us']:.2f} us device, bound "
                   f"{r['bound_us']:.2f} us (bytes), "
                   f"{100 * r['share_of_bound']:.1f}% of bound", flush=True)
        run.stages["kernels"]["rows"] = rows
    return run


def summary(run: Run, n_steps: int, n_segs: int, n_paths: int) -> dict:
    out = dict(steps=n_steps, segments=n_segs, paths=n_paths,
               device=str(run.device), stages=run.stages)
    if run.device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(run.device)
        # Each stage resets the peak: the run's is the largest stage's.
        out["max_memory_allocated"] = max(
            r["peak_bytes"] for r in run.stages.values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int,
                    default=int(os.environ.get("POLLEN_CHR8_STEPS", CHR8_STEPS)))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        from ..kernels import _build

        t0 = time.perf_counter()
        _build.load()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    run = run_checks(args.steps, device=device)
    seconds = time.perf_counter() - t0
    print(f"all stages exact; the run {seconds} s", flush=True)
    out = summary(run, args.steps, CHR8_SEGS, CHR8_PATHS)
    print(json.dumps(dict(out, seconds=seconds), default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
