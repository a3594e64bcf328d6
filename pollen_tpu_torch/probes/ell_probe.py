"""Time and check the tiered split ELL family (K1-K4), the scan family
(K6-K8) and the scatter on the card: the port of the TPU probe
``probes/ell_probe.py``.

Stages (several may run in one process; a stage's argument follows it):

    ellk, elltall   one tall tier alone (K3)
    heavyk          the heavy nibble block alone (K2)
    ell             the parts query (K1 fused; K3 + K2 unfused)
    ellraw          K1 alone, through its wrapper (no query glue: the
                    kernel reads the raw mask itself)
    ellb, ellb3 [Q] the batched parts query (K4) at Q = 8, 16, 32 or Q;
                    ellb3 on an index forced to three tiers (k = 1, 4, 16)
    ellp16          pack16 tier slots against 32-bit slots of the same
                    plan (counts clipped at 255), each through K1
    ellp16ok        pack16 against the plain slot reduction: diff
    ellok           seg_depth_with_uniq_ell_permuted, un-permuted,
                    against the plain sorted-step path, element-wise
    ellbok, ellb3ok the batched parts against Q plain single queries
    ellcal1 tier:K:G | heavy:W | hrot:W
                    one calibration point of K3 or K2
    ellcal          K3 at k = 1 (G = 1, 2, 4, 8) and k = 4 (G = 1, 4), K2
                    at W = 4096, 16384, 32768, and their fixed and
                    marginal cost fits
    crossd          the crossing matrix, depth only (K2, uniq=False)
    scanb, scanx    the scan route: K6 + K7 (scanb) or its plain version
    runsk           the runs route: K8 + K7
    scatter         index_add_ of K2 = 256 to 32768 values

Run it on the card (default) or with ``--device cpu``, host clock:

    python -m pollen_tpu_torch.probes.ell_probe ellok ellcal1 tier:1:2
    POLLEN_BENCH_STEPS=30000 POLLEN_BENCH_SEGS=4096 \\
        python -m pollen_tpu_torch.probes.ell_probe ellok --device cpu

The graph is ``synth.synth_graph`` at POLLEN_BENCH_STEPS / SEGS / PATHS
(defaults 2^22 / 2^18 / 128, the reference bench's shape), ingested by
``build_graph``. Times are device µs per call from replaying a CUDA
graph of back-to-back calls (``timing.replay_us``); the reference's
chained ``fori_loop`` and its one-stage-per-process rule worked around
its link to the TPU and have no counterpart here. K2's tile is fixed in
``csrc/cross.cuh``, so the reference's forced-tiling point ``hrot``
runs as ``heavy:W`` and says so.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from ..device import ell_tiers
from ..kernels import crossmat as _cm
from ..kernels import ellscan as _ell
from .timing import events_us, time_call

STAGES = (
    "ellk", "elltall", "heavyk", "ell", "ellraw", "ellb", "ellb3",
    "ellp16", "ellp16ok", "ellok", "ellbok", "ellb3ok", "ellcal1",
    "ellcal", "crossd", "scanb", "scanx", "runsk", "scatter",
)
CAL_TIERS = ((1, (1, 2, 4, 8)), (4, (1, 4)))  # (k, row groups G)
CAL_WIDTHS = (4096, 16384, 32768)  # heavy block columns
CAL_P_PAD = 128  # paths of a calibration heavy block
SCATTER_KS = (256, 4096, 16384, 32768)


def bench_shape() -> tuple:
    """(steps, segments, paths) from POLLEN_BENCH_STEPS / SEGS / PATHS."""
    return (
        int(os.environ.get("POLLEN_BENCH_STEPS", 2**22)),
        int(os.environ.get("POLLEN_BENCH_SEGS", 2**18)),
        int(os.environ.get("POLLEN_BENCH_PATHS", 128)),
    )


def forced_planner(ks):
    """A stand-in for ``ellscan.plan_ell_tiers_n`` that splits at tiers
    of ``ks`` slots, the rest heavy."""

    def forced(runs_per_seg, big_seg, p_pad, max_tiers=3, objective="single"):
        crossed = runs_per_seg > 0
        valid = ~big_seg & crossed
        tiers, prev = [], np.zeros_like(valid)
        for k in ks:
            t = valid & (runs_per_seg <= k) & ~prev
            tiers.append(t)
            prev = prev | t
        return tuple(ks), tiers, crossed & ~prev

    return forced


@contextlib.contextmanager
def three_tiers(ks=(1, 4, 16)):
    """Plan every index built inside at a fixed split into tiers of
    ``ks`` slots, the rest heavy (the default is the reference's ellb3
    split)."""
    saved = _ell.plan_ell_tiers_n
    _ell.plan_ell_tiers_n = forced_planner(ks)
    try:
        yield
    finally:
        _ell.plan_ell_tiers_n = saved


def build(shape, device, forced_three: bool = False):
    """(arena, TorchGraph) of the synthetic graph ``shape`` on ``device``."""
    from ..device import build_graph
    from ..synth import synth_graph

    g = synth_graph(*shape)
    with three_tiers() if forced_three else contextlib.nullcontext():
        dg = build_graph(g, device)
    return g, dg


def describe(dg) -> str:
    return (
        f"t1 {tuple(dg.cross_ell.shape)} k{dg.ell_k} "
        f"t2 {tuple(dg.cross_ell2.shape)} k{dg.ell_k2} "
        f"t3 {tuple(dg.cross_ell3.shape)} k{dg.ell_k3} "
        f"pack16 {int(dg.ell_pack16)} classes {dg.ell_num_light}/"
        f"{dg.ell_num_mid}/{dg.ell_num_mid2}/{dg.ell_num_heavy} "
        f"hmat {tuple(dg.ell_heavy.shape)} res {tuple(dg.ell_heavy_res.shape)}"
    )


def _ones(n, device):
    return torch.ones(n, dtype=torch.int32, device=device)


def _diff(got, want) -> int:
    """Sum of |got - want| over pairs of int tensors (None on both sides
    skips; None on one side counts as a mismatch of -1)."""
    total = 0
    for a, b in zip(got, want):
        if a is None and b is None:
            continue
        if a is None or b is None or a.shape != b.shape:
            return -1
        total += int((a.long() - b.long()).abs().sum())
    return total


def _line(stage, us, clock, n_steps=None, tail=""):
    rate = f" ({n_steps / us / 1e3:.2f} G steps/s)" if n_steps else ""
    mark = "" if clock == "device" else f" [{clock}]"
    return f"{stage}: {us:.2f} us/query{rate}{mark} {tail}".rstrip()


def stage_tier(dg, n_steps, stage="ellk", say=print) -> dict:
    """ellk / elltall: the first tier alone (K3, pack16 as stored)."""
    mask = _ones(dg.num_paths, dg.device)
    tall, k = dg.cross_ell, dg.ell_k
    us, clock = time_call(
        lambda: _ell.masked_ell_depth_tall(tall, mask, k, pack16=bool(dg.ell_pack16)),
        dg.device,
    )
    say(_line(stage, us, clock, n_steps))
    return dict(us=us, clock=clock)


def stage_heavyk(dg, say=print) -> dict:
    """heavyk: the heavy nibble block alone (K2)."""
    if not dg.ell_heavy.numel():
        say("heavyk: the index has no heavy class")
        return dict(us=None, clock=None)
    heavy = dg.ell_heavy
    mask = _ones(heavy.shape[0] * 2, dg.device)
    us, clock = time_call(
        lambda: _cm.masked_cross_depth(heavy, mask, nibble=True), dg.device
    )
    say(_line("heavyk", us, clock, tail=f"(block {tuple(heavy.shape)})"))
    return dict(us=us, clock=clock)


def stage_ell(dg, n_steps, say=print) -> dict:
    """ell: the parts query as the router serves it."""
    from ..ops.depth import seg_depth_with_uniq_ell_parts

    mask = _ones(dg.num_paths, dg.device)
    us, clock = time_call(
        lambda: seg_depth_with_uniq_ell_parts(dg, mask), dg.device
    )
    say(_line("ell", us, clock, n_steps))
    return dict(us=us, clock=clock)


def stage_ellraw(dg, n_steps, say=print) -> dict:
    """ellraw: K1 alone on the index's tiers and heavy block."""
    tiers = ell_tiers(dg)
    mask = _ones(dg.num_paths, dg.device)
    us, clock = time_call(
        lambda: _ell.masked_ell_splitn_depth(
            [t for t, _ in tiers], dg.ell_heavy, mask,
            [k for _, k in tiers], pack16=bool(dg.ell_pack16),
        ),
        dg.device,
    )
    say(_line("ellraw", us, clock, n_steps))
    return dict(us=us, clock=clock)


def stage_ellb(dg, n_steps, qs=(8, 16, 32), stage="ellb", say=print) -> dict:
    """ellb / ellb3: the batched parts query (K4), µs per batch and per
    query."""
    from ..ops.depth import seg_depth_with_uniq_ell_batch_parts

    out = {}
    for q in qs:
        rng = np.random.default_rng(4)
        masks = torch.from_numpy(
            rng.integers(0, 2, (q, dg.num_paths)).astype(np.int32)
        ).to(dg.device)
        us, clock = time_call(
            lambda: seg_depth_with_uniq_ell_batch_parts(dg, masks), dg.device
        )
        mark = "" if clock == "device" else f" [{clock}]"
        say(f"{stage} q={q}: {us:.2f} us/batch ({us / q:.3f} us/query, "
            f"{n_steps * q / us / 1e3:.1f} G steps/s){mark}")
        out[q] = dict(us=us, clock=clock)
    return out


def _pack16_tiers(dg):
    """The first tier's slots with counts clipped at 255, as (pack16 tall,
    its stored words, 32-bit tall, k, flat clipped slots, slots
    clipped)."""
    flat = _ell.unfold_ell_tall(dg.cross_ell, dg.ell_k)
    if dg.ell_pack16:
        # The resident is already paired: un-pair back to 32-bit slots
        # before re-packing, or the odd halves read as path ids.
        flat = _ell.unpair_ell16(flat)
    flat = flat.cpu().numpy()
    path = (flat >> 16) & 0xFFFF
    cnt = flat & 0xFFFF
    clipped = int((cnt > 255).sum())
    ell_c = ((path << 16) | np.minimum(cnt, 255)).astype(np.int32)
    paired = _ell.pair_ell16(ell_c)
    dev = dg.device
    tall16 = torch.from_numpy(_ell.pack_ell_tall(paired)).to(dev)
    tall32 = torch.from_numpy(_ell.pack_ell_tall(ell_c)).to(dev)
    return tall16, paired.shape[0], tall32, ell_c.shape[0], ell_c, clipped


def stage_ellp16(dg, n_steps, check: bool, say=print) -> dict:
    """ellp16: K1 over pack16 slots against K1 over 32-bit slots of the
    same (clipped) tier, with the index's heavy block. ellp16ok: the
    pack16 launch against the plain slot reduction, diff (0 is exact).
    A graph with no heavy class runs the tiers alone (the launch then
    returns no heavy outputs)."""
    tall16, k16, tall32, k32, ell_c, clipped = _pack16_tiers(dg)
    heavy = dg.ell_heavy
    mask = _ones(dg.num_paths, dg.device)
    has_heavy = heavy.numel() > 0

    def run16():
        return _ell.masked_ell_splitn_depth(
            [tall16], heavy, mask, [k16], pack16=True
        )

    def run32():
        return _ell.masked_ell_splitn_depth([tall32], heavy, mask, [k32])

    if check:
        outs = run16()
        n = ell_c.shape[1]
        flat = torch.from_numpy(ell_c).to(dg.device)
        want = list(_ell.masked_ell_depth_plain(flat, mask))
        got = [outs[0][:n], outs[1][:n]]
        if has_heavy:
            mp = _cm.pad_mask(mask, heavy.shape[0] * 2)
            want += list(_cm.masked_cross_depth_plain(heavy, mp, nibble=True))
            got += [outs[2], outs[3]]
        total = _diff(got, want)
        say(f"ellp16ok: diff={total} ({clipped} slots clipped, heavy class "
            f"{'present' if has_heavy else 'absent'})")
        return dict(diff=total, clipped=clipped, heavy=has_heavy)
    us16, clock = time_call(run16, dg.device)
    us32, _ = time_call(run32, dg.device)
    say(_line("ellp16", us16, clock, n_steps,
              f"(32-bit slots {us32:.2f} us; {clipped} slots clipped, heavy "
              f"class {'present' if has_heavy else 'absent'})"))
    return dict(us=us16, us32=us32, clock=clock, clipped=clipped,
                heavy=has_heavy)


def unpermute(dg, d, u):
    """Natural-order copies of ``ell_order``-ordered vectors."""
    if not dg.ell_order.shape[0]:
        return d, u
    inv = torch.empty_like(dg.ell_order, dtype=torch.long)
    inv[dg.ell_order.long()] = torch.arange(
        dg.ell_order.shape[0], device=inv.device
    )
    return d[inv], u[inv]


def stage_ellok(dg, seed=3, say=print) -> dict:
    """ellok: the permuted query (kernels), un-permuted, against the
    plain sorted-step path, element-wise; and against the permuted
    query's own plain version without the un-permute."""
    from ..ops.depth import (
        seg_depth_with_uniq_ell_permuted,
        seg_depth_with_uniq_masked,
    )

    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(
        rng.integers(0, 2, dg.num_paths).astype(np.int32)
    ).to(dg.device)
    d, u = seg_depth_with_uniq_ell_permuted(dg, mask)
    d_p, u_p = seg_depth_with_uniq_ell_permuted(dg, mask, plain=True)
    total = _diff((d, u), (d_p, u_p))
    if total >= 0:
        d_n, u_n = unpermute(dg, d, u)
        total2 = _diff((d_n, u_n), seg_depth_with_uniq_masked(dg, mask))
        total = -1 if total2 < 0 else total + total2
    say(f"ellok: diff={total}")
    return dict(diff=total)


def stage_ellbok(dg, q=8, stage="ellbok", say=print) -> dict:
    """ellbok / ellb3ok: the batched parts (K4) against Q plain single
    parts queries, element-wise."""
    from ..ops.depth import (
        seg_depth_with_uniq_ell_batch_parts,
        seg_depth_with_uniq_ell_parts,
    )

    rng = np.random.default_rng(6)
    masks = torch.from_numpy(
        rng.integers(0, 2, (q, dg.num_paths)).astype(np.int32)
    ).to(dg.device)
    outs_b = seg_depth_with_uniq_ell_batch_parts(dg, masks)
    total = 0
    for i in range(q):
        outs_1 = seg_depth_with_uniq_ell_parts(dg, masks[i], plain=True)
        rows = [None if b is None else b[i] for b in outs_b]
        d = _diff(rows, outs_1)
        if d < 0:
            total = -1
            break
        total += d
    say(f"{stage}: diff={total}")
    return dict(diff=total)


def _cal_tier(kk, g, mask, rng):
    rows = g * kk * _ell.SUB
    tall = torch.from_numpy(
        rng.integers(0, 1 << 22, (rows, _ell.TALL_W), dtype=np.int32)
    ).to(mask.device)
    us, clock = time_call(
        lambda: _ell.masked_ell_depth_tall(tall, mask, kk), mask.device
    )
    return us, clock, rows * _ell.TALL_W


def _cal_heavy(w, rng, device):
    hm = torch.from_numpy(
        rng.integers(0, 256, (CAL_P_PAD // 2, w), dtype=np.int32)
        .astype(np.uint8)
    ).to(device)
    hmask = _ones(CAL_P_PAD, device)
    us, clock = time_call(
        lambda: _cm.masked_cross_depth(hm, hmask, nibble=True), device
    )
    return us, clock, (CAL_P_PAD // 2) * w


def stage_ellcal1(dg, spec: str, say=print) -> dict:
    """ellcal1 tier:K:G | heavy:W | hrot:W[:FW:FROT]: one calibration
    point (K3 on G row groups of K stored words of random slots, or K2
    on a random 64 x W nibble block)."""
    rng = np.random.default_rng(12)
    kind, *params = spec.split(":")
    if kind == "tier":
        kk, g = int(params[0]), int(params[1])
        mask = _ones(dg.num_paths, dg.device)
        us, clock, slots = _cal_tier(kk, g, mask, rng)
        say(f"ellcal1 tier k={kk} g={g}: {us:.2f} us ({slots} slots) "
            f"[{clock}]")
        return dict(kind="tier", k=kk, g=g, slots=slots, us=us, clock=clock)
    if kind not in ("heavy", "hrot"):
        raise ValueError(f"ellcal1: unknown point {spec!r}")
    w = int(params[0])
    us, clock, nbytes = _cal_heavy(w, rng, dg.device)
    note = ""
    if kind == "hrot":
        note = (" (hrot: K2's tile is fixed in csrc/cross.cuh, so forced "
                "tiling has no meaning here; timed as heavy:W)")
    say(f"ellcal1 heavy w={w}: {us:.2f} us ({nbytes} bytes) [{clock}]{note}")
    return dict(kind="heavy", w=w, bytes=nbytes, us=us, clock=clock)


def fit(xs, ys) -> tuple:
    """(fixed, marginal) of a least-squares line ys = fixed + marginal*xs."""
    slope, intercept = np.polyfit(np.asarray(xs, float), np.asarray(ys, float), 1)
    return float(intercept), float(slope)


def stage_ellcal(dg, tiers=CAL_TIERS, widths=CAL_WIDTHS, say=print) -> dict:
    """ellcal: the calibration points and the fixed + marginal fit of
    each (K3 per k, over slots; K2 over heavy bytes)."""
    rng = np.random.default_rng(12)
    mask = _ones(dg.num_paths, dg.device)
    out = {"tier": {}, "heavy": []}
    for kk, gs in tiers:
        pts = []
        for g in gs:
            us, clock, slots = _cal_tier(kk, g, mask, rng)
            say(f"ellcal tier k={kk} g={g}: {us:.2f} us ({slots} slots) "
                f"[{clock}]")
            pts.append(dict(g=g, slots=slots, us=us))
        entry = dict(points=pts)
        if len(pts) > 1:
            a, b = fit([p["slots"] for p in pts], [p["us"] for p in pts])
            entry.update(fixed_us=a, ns_per_slot=b * 1e3)
            say(f"ellcal tier k={kk} fit: {a:.2f} us fixed + "
                f"{b * 1e3:.5f} ns/slot")
        out["tier"][kk] = entry
    for w in widths:
        us, clock, nbytes = _cal_heavy(w, rng, dg.device)
        say(f"ellcal heavy w={w}: {us:.2f} us ({nbytes} bytes) [{clock}]")
        out["heavy"].append(dict(w=w, bytes=nbytes, us=us))
    if len(out["heavy"]) > 1:
        a, b = fit([p["bytes"] for p in out["heavy"]],
                   [p["us"] for p in out["heavy"]])
        out.update(heavy_fixed_us=a, heavy_ns_per_byte=b * 1e3)
        say(f"ellcal heavy fit: {a:.2f} us fixed + {b * 1e3:.5f} ns/byte")
    say("ellcal: done")
    return out


def stage_crossd(dg, n_steps, say=print) -> dict:
    """crossd: the resident crossing matrix, depth only (K2)."""
    if not dg.cross_matrix.numel():
        say("crossd: no crossing matrix resident")
        return dict(us=None, clock=None)
    cross, nib = dg.cross_matrix, dg.cross_nibble
    mask = _ones(cross.shape[0] * (2 if nib else 1), dg.device)
    us, clock = time_call(
        lambda: _cm.masked_cross_depth(cross, mask, nibble=nib, uniq=False),
        dg.device,
    )
    say(_line("crossd", us, clock, n_steps))
    return dict(us=us, clock=clock)


def stage_scan(dg, n_steps, stage="scanb", say=print) -> dict:
    """scanb: the scan route's kernels (K6 + K7); scanx: its plain
    torch version (the reference's XLA boundary stage), which reads a
    flag back to the host and so is timed by CUDA events, not a graph
    replay."""
    from ..ops.depth import seg_depth_with_uniq_fused

    mask = _ones(dg.num_paths, dg.device)
    plain = stage == "scanx"
    timer = events_us if plain else time_call
    us, clock = timer(
        lambda: seg_depth_with_uniq_fused(dg, mask, plain=plain), dg.device
    )
    say(_line(stage, us, clock, n_steps))
    return dict(us=us, clock=clock)


def stage_runsk(dg, n_steps, say=print) -> dict:
    """runsk: the runs route's kernels (K8 + K7) on the graph's run
    index."""
    from ..ops.depth import seg_depth_with_uniq_runs_fused

    mask = _ones(dg.num_paths, dg.device)
    r = int(dg.run_seg_bounds[-1])
    us, clock = time_call(
        lambda: seg_depth_with_uniq_runs_fused(dg, mask), dg.device
    )
    say(_line("runsk", us, clock, n_steps,
              f"(runs {r}, {r / us / 1e3:.2f} G runs/s)"))
    return dict(us=us, clock=clock, runs=r)


def stage_scatter(dg, ks=SCATTER_KS, say=print) -> dict:
    """scatter: a copy of an int32 segment vector plus ``index_add_`` of
    K2 sorted distinct ids (the reference's ``depth.at[ids].add``)."""
    rng = np.random.default_rng(5)
    n = dg.num_segments
    base = torch.zeros(n, dtype=torch.int32, device=dg.device)
    out = {}
    for k2 in ks:
        k2 = min(k2, n)
        ids = torch.from_numpy(
            np.sort(rng.choice(n, size=k2, replace=False)).astype(np.int64)
        ).to(dg.device)
        vals = torch.from_numpy(
            rng.integers(1, 100, k2).astype(np.int32)
        ).to(dg.device)
        us, clock = time_call(
            lambda: base.clone().index_add_(0, ids, vals), dg.device
        )
        say(f"scatter k2={k2}: {us:.2f} us [{clock}]")
        out[k2] = dict(us=us, clock=clock)
    say("scatter: done")
    return out


def run_stage(stage, arg, dg, n_steps, say=print):
    """Run one stage on the ingested graph ``dg``; returns its numbers
    (a dict; check stages hold ``diff``, 0 where exact)."""
    if stage in ("ellk", "elltall"):
        return stage_tier(dg, n_steps, stage, say)
    if stage == "heavyk":
        return stage_heavyk(dg, say)
    if stage == "ell":
        return stage_ell(dg, n_steps, say)
    if stage == "ellraw":
        return stage_ellraw(dg, n_steps, say)
    if stage in ("ellb", "ellb3"):
        qs = (int(arg),) if arg else (8, 16, 32)
        return stage_ellb(dg, n_steps, qs, stage, say)
    if stage in ("ellp16", "ellp16ok"):
        return stage_ellp16(dg, n_steps, stage == "ellp16ok", say)
    if stage == "ellok":
        return stage_ellok(dg, say=say)
    if stage in ("ellbok", "ellb3ok"):
        return stage_ellbok(dg, stage=stage, say=say)
    if stage == "ellcal1":
        if not arg:
            raise ValueError("ellcal1 needs a point: tier:K:G, heavy:W, hrot:W")
        return stage_ellcal1(dg, arg, say)
    if stage == "ellcal":
        return stage_ellcal(dg, say=say)
    if stage == "crossd":
        return stage_crossd(dg, n_steps, say)
    if stage in ("scanb", "scanx"):
        return stage_scan(dg, n_steps, stage, say)
    if stage == "runsk":
        return stage_runsk(dg, n_steps, say)
    if stage == "scatter":
        return stage_scatter(dg, say=say)
    raise ValueError(f"unknown stage {stage!r}")


def parse_stages(tokens) -> list:
    """[(stage, argument or None)]: a token that names no stage is the
    argument of the stage before it."""
    out = []
    for tok in tokens:
        if tok in STAGES:
            out.append([tok, None])
        elif out and out[-1][1] is None:
            out[-1][1] = tok
        else:
            raise ValueError(f"unknown stage {tok!r}; choose from {STAGES}")
    return [tuple(s) for s in out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="+", help="stages, each with its argument")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        stages = parse_stages(args.stages)
    except ValueError as exc:
        ap.error(str(exc))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")
    shape = bench_shape()
    graphs = {}
    ok = True
    for stage, arg in stages:
        three = stage.startswith("ellb3")
        if three not in graphs:
            t0 = time.perf_counter()
            graphs[three] = build(shape, device, forced_three=three)[1]
            print(f"# ingest {time.perf_counter() - t0:.1f}s"
                  f"{' (three tiers forced)' if three else ''}; "
                  f"{describe(graphs[three])}", flush=True)
        res = run_stage(stage, arg, graphs[three], shape[0],
                        say=lambda s: print(s, flush=True))
        if isinstance(res, dict) and res.get("diff", 0) != 0:
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
