"""Depth queries: per-segment crossing counts and per-path mean depth.

A port of pollen_tpu/ops/depth.py's single and batched masked queries
(odgi ``depth -d``, ``depth -d -s``, and ``depth -S``, many subsets in
one device pass): the router picks the cheapest resident index with
the reference's cost model, and every route it can pick runs its CUDA
kernels on a CUDA graph: the tiered split ELL ("ell"), the crossing
matrix ("cross"), and the scan family for graphs past both budgets
("runs" over the run index, "scan" and "xla" over the sorted steps).
On a CPU graph each wrapper runs its plain version. ``plain=True``
runs a route's plain PyTorch version on any device (the reference's
``pallas=False``), which is what the kernels are held to. On a card the
single query's device parts on the cross, scan and runs routes replay a
CUDA graph captured once per graph, route and mask shape
(:func:`_route_part`).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import profiling
from ..flatgfa import GraphArrays

from ..device import (
    TorchGraph,
    bounded_segment_sum,
    first_in_group_mask,
    op_tensor,
)
from ..kernels import crossmat as _cm
from ..kernels import ellscan as _ell
from ..kernels import gatherb as _gb
from ..kernels import runscan as _rs
from ..kernels import segscan as _ss


def seg_depth_with_uniq(dg: TorchGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth, unique depth) per segment over all paths: boundary
    differences of the ingest index, no per-step work."""
    depth = dg.seg_bounds[1:] - dg.seg_bounds[:-1]
    uniq = dg.run_seg_bounds[1:] - dg.run_seg_bounds[:-1]
    return depth, uniq


def _as_mask(dg: TorchGraph, mask) -> torch.Tensor:
    """A path mask, or a (Q, P) batch of them, as the reference takes
    it (a numpy array or a tensor, bool or 0/1) as a tensor on the
    graph's device. Every public query that takes masks converts here,
    once, at its entry."""
    return op_tensor(mask, dg.device, move=True)


def _pinned_copies(parts: list) -> Optional[list]:
    """Page-locked host copies of ``parts``, tensors on one CUDA device,
    complete on return: a buffer each from torch's caching host
    allocator, the copies enqueued on the current stream, one wait for
    that stream. Counts the buffers asked for (``depth.to_host_pinned``).
    None where page-locking fails; nothing is copied then."""
    try:
        hosts = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in parts]
    except RuntimeError:
        return None
    profiling.count("depth.to_host_pinned", len(hosts))
    for h, x in zip(hosts, parts):
        h.copy_(x, non_blocking=True)
    torch.cuda.current_stream(parts[0].device).synchronize()
    return hosts


def _to_host(*parts) -> list:
    """Host numpy copies of the answers ``parts`` (None stays None; the
    others on the graph's device), all in one span
    ``pollen.depth.to_host`` (no gap of the caller's between two
    copies), with their bytes added to the counter
    ``depth.to_host_bytes``. The span holds the wait for the device work
    queued before the copies.

    From a CUDA graph the copies land in page-locked memory from torch's
    caching host allocator (:func:`_pinned_copies`), which the returned
    arrays hold: once the caller drops an array (and every view of it),
    a later call of the same size reuses its block, so no call touches
    fresh pages, and arrays of two calls never share memory. The
    allocator keeps the process's peak of answers held at once, each
    block rounded up to a power of two; ``torch._C._host_emptyCache()``
    (``torch.accelerator.empty_host_cache()`` in later torch) gives the
    blocks no answer holds back. Where page-locking fails, pageable
    ``.cpu()`` copies; from a CPU graph, the parts themselves, as
    before."""
    with profiling.span("pollen.depth.to_host"):
        live = [x for x in parts if x is not None]
        host = _pinned_copies(live) if live and live[0].is_cuda else None
        if host is None:
            host = [x.cpu() for x in live]
        it = iter(host)
        out = [None if x is None else next(it).numpy() for x in parts]
    profiling.count("depth.to_host_bytes",
                    sum(a.nbytes for a in out if a is not None))
    return out


def seg_depth_with_uniq_masked(
    dg: TorchGraph, path_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked (depth, uniq) over the sorted step index: the reference's
    portable XLA form, in plain torch."""
    w = _ss.lookup_mask(_as_mask(dg, path_mask)[: dg.num_paths], dg.step_path_sorted)
    depth = bounded_segment_sum(w, dg.seg_bounds)
    uniq = bounded_segment_sum(first_in_group_mask(w, dg.run_start), dg.seg_bounds)
    return depth, uniq


def seg_depth_with_uniq_runs(
    dg: TorchGraph, path_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked (depth, uniq) over the run-level index: the reference's
    portable XLA form, in plain torch."""
    w = _ss.lookup_mask(_as_mask(dg, path_mask)[: dg.num_paths], dg.run_path)
    depth = bounded_segment_sum(w * dg.run_count, dg.run_seg_bounds)
    uniq = bounded_segment_sum(w, dg.run_seg_bounds)
    return depth, uniq


def _count_scan(elements: int) -> None:
    """One pass of a scan kernel (K6 or K8, or its plain version) over
    ``elements`` padded steps or padded runs: counters
    ``depth.scan_passes`` and ``depth.scan_elements``."""
    profiling.count("depth.scan_passes")
    profiling.count("depth.scan_elements", elements)


def seg_depth_with_uniq_fused(
    dg: TorchGraph, path_mask: torch.Tensor, plain: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked (depth, uniq) on the "scan" route: the segment scan (K6)
    over the sorted steps, then the boundary stage (K7) on both cumsums,
    int32 on the graph's device. Counts the pass (:func:`_count_scan`)."""
    m = _as_mask(dg, path_mask)[: dg.num_paths]
    args = (dg.step_path_sorted, dg.run_start, m)
    _count_scan(dg.padded_steps)
    if plain:
        csums = _ss.masked_depth_cumsums_plain(*args)
        return _gb.gather_boundary_diff_plain(csums, dg.seg_bounds)
    return _ss.depth_uniq_from_cumsums(
        *_ss.masked_depth_cumsums(*args), dg.seg_bounds
    )


def seg_depth_with_uniq_runs_fused(
    dg: TorchGraph, path_mask: torch.Tensor, plain: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked (depth, uniq) on the "runs" route: the run scan (K8) over
    the run index, then the boundary stage (K7) on both cumsums, int32
    on the graph's device. Counts the pass (:func:`_count_scan`)."""
    m = _as_mask(dg, path_mask)[: dg.num_paths]
    args = (dg.run_path, dg.run_count, m)
    _count_scan(dg.run_path.shape[0])
    if plain:
        csums = _rs.masked_run_cumsums_plain(*args)
        return _gb.gather_boundary_diff_plain(csums, dg.run_seg_bounds)
    return _gb.gather_boundary_diff(
        _rs.masked_run_cumsums(*args), dg.run_seg_bounds
    )


def _residual(res: torch.Tensor, mp: torch.Tensor) -> torch.Tensor:
    """Masked column sums of an int32 residual sidecar, exact int32."""
    return (res * mp[:, None]).sum(dim=0, dtype=torch.int32)


def _residual_batch(res: torch.Tensor, mp: torch.Tensor) -> torch.Tensor:
    """:func:`_residual` for (Q, P_pad) masks -> int32 (Q, K). Exact:
    float64 products and sums of integers far below 2^53 (torch.matmul
    has no int32 CUDA form)."""
    return (mp.to(torch.float64) @ res.to(torch.float64)).to(torch.int32)


def seg_depth_with_uniq_cross(
    dg: TorchGraph, path_mask: torch.Tensor, plain: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked (depth, uniq) over the dense crossing matrix plus its
    residual sidecar."""
    p_pad = dg.cross_matrix.shape[0] * (2 if dg.cross_nibble else 1)
    m = _cm.pad_mask(_as_mask(dg, path_mask)[: dg.num_paths], p_pad)
    fn = _cm.masked_cross_depth_plain if plain else _cm.masked_cross_depth
    depth, uniq = fn(dg.cross_matrix, m, nibble=dg.cross_nibble)
    if dg.cross_res_seg.numel():
        fix = _residual(dg.cross_res, m)
        # Sentinel padding columns carry an out-of-range segment id:
        # route them to column 0 with a zero contribution.
        valid = dg.cross_res_seg < depth.shape[0]
        idx = torch.where(valid, dg.cross_res_seg, 0).long()
        depth = depth.index_add(0, idx, fix * valid.to(torch.int32))
    return depth[: dg.num_segments], uniq[: dg.num_segments]


def seg_depth_with_uniq_ell_parts(
    dg: TorchGraph, path_mask: torch.Tensor, plain: bool = False
):
    """Masked (depth, uniq) over the tiered split ELL index as per-class
    part vectors ``(d1, u1, d2, u2, dh, uh)`` on the graph's device; the
    tier-2 and heavy pairs are None when absent, and a third tier is
    folded into the mid pair (tier-2 columns first). The heavy clip
    residual is applied."""
    _ell.check_ell_sub(dg.ell_sub)
    m = _as_mask(dg, path_mask).to(torch.int32)[: dg.num_paths]
    has_mid = dg.cross_ell2.numel() > 0
    has_mid2 = dg.cross_ell3.numel() > 0
    has_heavy = dg.ell_heavy.numel() > 0
    # The reference fuses only when the heavy block is SEG_BLOCK padded
    # (its rotated output tiles); the port keeps the same split so that
    # both kernels of the unfused form stay on the path for small graphs.
    fusable = has_heavy and dg.ell_heavy.shape[1] % _cm.SEG_BLOCK == 0
    pack16 = bool(dg.ell_pack16)
    heavy_p_pad = dg.ell_heavy.shape[0] * 2

    def tier(tall, k):
        if plain:
            return _ell.masked_ell_depth_tall_plain(tall, m, k, pack16)
        return _ell.masked_ell_depth_tall(tall, m, k, pack16=pack16)

    def cat_mid(d2, u2, d3, u3):
        nm, nm2 = dg.ell_num_mid, dg.ell_num_mid2
        return torch.cat([d2[:nm], d3[:nm2]]), torch.cat([u2[:nm], u3[:nm2]])

    tiers = [(dg.cross_ell, dg.ell_k)]
    if has_mid:
        tiers.append((dg.cross_ell2, dg.ell_k2))
    if has_mid2:
        tiers.append((dg.cross_ell3, dg.ell_k3))
    dh = uh = None
    if fusable and not plain:
        outs = _ell.masked_ell_splitn_depth(
            [t for t, _ in tiers], dg.ell_heavy, m,
            ks=[k for _, k in tiers], pack16=pack16,
        )
        parts = [outs[2 * i : 2 * i + 2] for i in range(len(tiers))]
        dh, uh = outs[-2], outs[-1]
    else:
        parts = [tier(t, k) for t, k in tiers]
        if has_heavy:
            mp = _cm.pad_mask(m, heavy_p_pad)
            fn = _cm.masked_cross_depth_plain if plain else _cm.masked_cross_depth
            dh, uh = fn(dg.ell_heavy, mp, nibble=True)
    d1, u1 = parts[0]
    d2 = u2 = None
    if has_mid:
        d2, u2 = parts[1]
    if has_mid2:
        d3, u3 = parts[-1]
        d2, u2 = cat_mid(d2, u2, d3, u3) if has_mid else (d3, u3)
    if has_heavy and dg.ell_heavy_res_col.numel():
        # Overflow columns occupy the heavy block's prefix (ingest).
        # dh is this query's own fresh output, so the add is in place.
        fix = _residual(dg.ell_heavy_res, _cm.pad_mask(m, heavy_p_pad))
        dh[: dg.ell_heavy_res.shape[1]] += fix
    return d1, u1, d2, u2, dh, uh


def _ell_pieces(dg: TorchGraph, parts):
    """The per-class parts ``(d1, u1, d2, u2, dh, uh)`` (columns on the
    last axis) cut to their classes in ``ell_order`` ([tier 1, tiers
    2+3, heavy]): ``(depth pieces, uniq pieces, empty columns)``, or
    None where there is no order and no second part (the first tier is
    then the whole answer)."""
    d1, u1, d2, u2, dh, uh = parts
    if d2 is None and dh is None and not dg.ell_order.shape[0]:
        return None
    nl, nh = dg.ell_num_light, dg.ell_num_heavy
    nm = dg.ell_num_mid + dg.ell_num_mid2  # the mid part folds tiers 2+3
    dparts, uparts = [d1[..., :nl]], [u1[..., :nl]]
    if d2 is not None:
        dparts.append(d2[..., :nm])
        uparts.append(u2[..., :nm])
    if dh is not None:
        dparts.append(dh[..., :nh])
        uparts.append(uh[..., :nh])
    return dparts, uparts, dg.num_segments - nl - nm - nh


def seg_depth_with_uniq_ell_permuted(
    dg: TorchGraph, path_mask: torch.Tensor, plain: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked (depth, uniq) in the index's own ``ell_order`` ([tier 1,
    tiers 2+3, heavy, empty]) as two int32 vectors on the graph's
    device: the parts query plus one concatenate (the empty tail is a
    zero block), with no host round trip and no un-permute. Prefer the
    parts form on hot paths."""
    parts = seg_depth_with_uniq_ell_parts(dg, path_mask, plain=plain)
    pieces = _ell_pieces(dg, parts)
    if pieces is None:
        n = dg.num_segments
        return parts[0][:n], parts[1][:n]
    dparts, uparts, ne = pieces
    zero = torch.zeros(ne, dtype=torch.int32, device=parts[0].device)
    return torch.cat(dparts + [zero]), torch.cat(uparts + [zero])


def _compose_ell(dg: TorchGraph, parts) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class ``(d1, u1, d2, u2, dh, uh)`` parts of shape (Q, class
    columns) -> host int32 (depth, uniq) of shape (Q, N) in natural
    segment order: composed and un-permuted by ``ell_order`` on the host,
    as the reference does (the span ``pollen.depth.compose``; the parts'
    and the order's copies are one ``pollen.depth.to_host`` in it)."""
    with profiling.span("pollen.depth.compose"):
        n = dg.num_segments
        *parts, order = _to_host(
            *parts, dg.ell_order if dg.ell_order.shape[0] else None
        )
        pieces = _ell_pieces(dg, parts)
        if pieces is None:
            return parts[0][:, :n], parts[1][:, :n]
        dparts, uparts, ne = pieces
        empty = np.zeros((parts[0].shape[0], ne), np.int32)
        d = np.concatenate(dparts + [empty], axis=1)
        u = np.concatenate(uparts + [empty], axis=1)
        if order is not None:
            inv = np.empty(n, np.int64)
            inv[order] = np.arange(n)
            d, u = d[:, inv], u[:, inv]
        return d, u


def seg_depth_with_uniq_ell(
    dg: TorchGraph, path_mask: torch.Tensor, plain: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked (depth, uniq) over the tiered split ELL index in natural
    segment order, composed and un-permuted on the host (CPU tensors)."""
    with profiling.span("pollen.depth.device"):
        parts = seg_depth_with_uniq_ell_parts(dg, path_mask, plain=plain)
    d, u = _compose_ell(dg, [None if x is None else x[None] for x in parts])
    return torch.from_numpy(d[0]), torch.from_numpy(u[0])


def seg_depth_with_uniq_ell_batch_parts(
    dg: TorchGraph, path_masks: torch.Tensor, plain: bool = False
):
    """Batched masked (depth, uniq) over the tiered split ELL index as
    per-class parts ``(d1, u1, d2, u2, dh, uh)`` of shape (Q, class
    columns) on the graph's device, in one launch of the batched kernel
    for any tier count; absent classes are None, a third tier is folded
    into the mid pair (tier-2 columns first), and the heavy clip
    residual is applied."""
    _ell.check_ell_sub(dg.ell_sub)
    m = _as_mask(dg, path_masks).to(torch.int32)[:, : dg.num_paths]
    tiers = [(dg.cross_ell, dg.ell_k)]
    for tall, k in ((dg.cross_ell2, dg.ell_k2), (dg.cross_ell3, dg.ell_k3)):
        if tall.numel():
            tiers.append((tall, k))
    fn = (
        _ell.masked_ell_splitn_depth_batch_plain
        if plain
        else _ell.masked_ell_splitn_depth_batch
    )
    *tier_outs, dh, uh = fn(
        [t for t, _ in tiers], dg.ell_heavy, m, [k for _, k in tiers],
        pack16=bool(dg.ell_pack16),
    )
    d1, u1 = tier_outs[0], tier_outs[1]
    d2 = u2 = None
    if dg.cross_ell2.numel():
        d2, u2 = tier_outs[2], tier_outs[3]
    if dg.cross_ell3.numel():
        d3, u3 = tier_outs[-2], tier_outs[-1]
        if d2 is None:
            d2, u2 = d3, u3
        else:
            nm, nm2 = dg.ell_num_mid, dg.ell_num_mid2
            d2 = torch.cat([d2[:, :nm], d3[:, :nm2]], dim=1)
            u2 = torch.cat([u2[:, :nm], u3[:, :nm2]], dim=1)
    if dh is not None and dg.ell_heavy_res_col.numel():
        # Overflow columns occupy the heavy block's prefix (ingest);
        # dh is this batch's own fresh output, so the add is in place.
        mp = _cm.pad_mask(m, dg.ell_heavy.shape[0] * 2)
        dh[:, : dg.ell_heavy_res.shape[1]] += _residual_batch(
            dg.ell_heavy_res, mp
        )
    return d1, u1, d2, u2, dh, uh


# Largest batch per launch, as in the reference (its VMEM budget): it
# bounds the launch's (Q, columns) outputs, and tier plans made for
# ell_objective="batch" assume this batch size (ELL_BATCH_Q).
ELL_BATCH_CHUNK = _ell.ELL_BATCH_Q


def seg_depth_with_uniq_ell_batch(
    dg: TorchGraph, path_masks: torch.Tensor, plain: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched tiered-ELL queries as host int32 (Q, N) arrays in natural
    segment order, one launch per ELL_BATCH_CHUNK masks. The reference
    also pads Q up to a power of two to bound Mosaic recompiles; a CUDA
    launch compiles nothing per shape, so a ragged Q runs as it is."""
    path_masks = _as_mask(dg, path_masks)
    chunks = []
    for i in range(0, path_masks.shape[0], ELL_BATCH_CHUNK):
        with profiling.span("pollen.depth.device"):
            parts = seg_depth_with_uniq_ell_batch_parts(
                dg, path_masks[i : i + ELL_BATCH_CHUNK], plain=plain
            )
        chunks.append(_compose_ell(dg, parts))
    return (
        np.concatenate([d for d, _ in chunks]),
        np.concatenate([u for _, u in chunks]),
    )


def seg_depth_with_uniq_cross_batch(
    dg: TorchGraph, path_masks: torch.Tensor, plain: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched masked (depth, uniq) over the dense crossing matrix plus
    its residual sidecar: int32 (Q, N) on the graph's device."""
    p_pad = dg.cross_matrix.shape[0] * (2 if dg.cross_nibble else 1)
    m = _cm.pad_mask(_as_mask(dg, path_masks)[:, : dg.num_paths], p_pad)
    fn = _cm.batched_cross_depth_plain if plain else _cm.batched_cross_depth
    depth, uniq = fn(dg.cross_matrix, m, nibble=dg.cross_nibble)
    if dg.cross_res_seg.numel():
        fix = _residual_batch(dg.cross_res, m)
        # Sentinel padding columns carry an out-of-range segment id:
        # route them to column 0 with a zero contribution.
        valid = dg.cross_res_seg < depth.shape[1]
        idx = torch.where(valid, dg.cross_res_seg, 0).long()
        depth = depth.index_add(1, idx, fix * valid.to(torch.int32))
    return depth[:, : dg.num_segments], uniq[:, : dg.num_segments]


# Router constants, unchanged from the reference (TPU fits,
# pollen_tpu/ops/depth.py): the port routes every graph as the reference
# does until H100 constants are measured.
_SCAN_EQUIV_BYTES = 270
_RUNS_EQUIV_BYTES = 1380
_BND_EQUIV_BYTES = 1000
_BND_XLA_EQUIV_BYTES = 6100
_XLA_EQUIV_BYTES = 6700


def _masked_impl_costs(dg: TorchGraph) -> dict:
    """Equivalent streamed bytes per masked-depth query, per resident
    index (shape arithmetic only)."""

    def bnd(planned: bool) -> int:
        per = _BND_EQUIV_BYTES if planned else _BND_XLA_EQUIV_BYTES
        return per * (dg.num_segments + 1)

    costs = {
        "scan": _SCAN_EQUIV_BYTES * dg.padded_steps + bnd(dg.bnd_w_rows > 0),
        "xla": _XLA_EQUIV_BYTES * dg.padded_steps,
    }
    if dg.run_path.shape[0]:
        costs["runs"] = _RUNS_EQUIV_BYTES * dg.run_path.shape[0] + bnd(
            dg.bnd2_w_rows > 0
        )
    if dg.cross_matrix.numel():
        costs["cross"] = dg.cross_matrix.numel() + 4 * dg.cross_res.numel()
    if dg.cross_ell.numel():
        a = _ell.c_slot_a(-(-max(dg.num_paths, 1) // 32))
        cost_ell = 0.0
        for tall, k in (
            (dg.cross_ell, dg.ell_k),
            (dg.cross_ell2, dg.ell_k2),
            (dg.cross_ell3, dg.ell_k3),
        ):
            if tall.numel() and k:
                size = tall.numel()
                cost_ell += _ell.C_TIER_FIXED + a * size + _ell.C_COL_B * size / k
        if dg.ell_heavy.numel():
            cost_ell += (
                _ell.C_TIER_FIXED
                + _ell.C_HEAVY_PER_BYTE * dg.ell_heavy.numel()
                + 8 * dg.ell_heavy_res.numel()
            )
        costs["ell"] = cost_ell
    return costs


def _best_masked_impl(dg: TorchGraph) -> str:
    costs = _masked_impl_costs(dg)
    return min(costs, key=costs.get)


def _cross_beats_scan(dg: TorchGraph) -> bool:
    """Whether the dense crossing matrix is the cheapest masked-depth
    index (the reference's form for callers that predate the ELL)."""
    return _best_masked_impl(dg) == "cross"


class _RoutePart:
    """One key's device part: after its first (eager) call, the captured
    CUDA graph with its static mask, its outputs, the ``depth.*`` counts
    a replay adds and the stream of its last replay; or ``failed`` once
    a capture raised."""

    __slots__ = ("graph", "mask", "outs", "added", "stream", "failed")

    def __init__(self):
        self.graph = None
        self.failed = False


def _depth_counts() -> dict:
    return {k: v for k, v in profiling.counters().items() if k.startswith("depth.")}


def _warm(dg: TorchGraph, fn, mask: torch.Tensor):
    """A key's first call: eager, on a side stream (as capture wants its
    kernels' first calls), joined back to the current stream."""
    cur = torch.cuda.current_stream(mask.device)
    side = torch.cuda.Stream(mask.device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        outs = fn(dg, mask, plain=False)
    cur.wait_stream(side)
    for t in outs:
        t.record_stream(cur)
    return outs


def _capture(part: _RoutePart, dg: TorchGraph, fn, mask: torch.Tensor):
    """A key's second call: capture its device part into a CUDA graph
    (the outputs and every buffer in between in the graph's private
    pool; a scan's memset a node), then replay it for this call. The
    ``depth.*`` counts the capture adds (a scan's pass and elements) are
    this call's, and each replay adds them again; the kernel wrappers'
    launch counts move only here, where the wrappers run. If the capture
    raises, its ``depth.*`` counts are taken back and the key runs
    eagerly from then on (``depth.route_uncaptured`` a call)."""
    before = _depth_counts()
    static = mask.clone()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            outs = fn(dg, static, plain=False)
        failed = False
    except RuntimeError:
        failed = True
    added = {k: v - before.get(k, 0) for k, v in _depth_counts().items()
             if v != before.get(k, 0)}
    if failed:
        for k, n in added.items():
            profiling.count(k, -n)
        part.failed = True
        profiling.count("depth.route_uncaptured")
        return fn(dg, mask, plain=False)
    part.graph, part.mask, part.outs, part.added = graph, static, outs, added
    part.stream = torch.cuda.current_stream(mask.device)
    profiling.count("depth.route_graphs")
    graph.replay()
    return outs


def _replay(part: _RoutePart, mask: torch.Tensor):
    cur = torch.cuda.current_stream(mask.device)
    if cur != part.stream:
        # The last replay may still read the static mask.
        cur.wait_stream(part.stream)
        part.stream = cur
    part.mask.copy_(mask)
    part.graph.replay()
    for k, n in part.added.items():
        profiling.count(k, n)
    profiling.count("depth.route_replays")
    return part.outs


def _route_part(dg: TorchGraph, fn, mask: torch.Tensor):
    """``fn``'s device part on a CUDA graph through the graph's captured
    parts (``dg.route_parts``, a key a route fn, mask shape and dtype):
    the first call of a key eager, the second captured and replayed,
    later ones a copy of the mask into the static input and one replay.
    Counts ``depth.route_parts`` a call, ``depth.route_graphs`` a
    capture and ``depth.route_replays`` a later call's replay."""
    profiling.count("depth.route_parts")
    key = (fn, tuple(mask.shape), mask.dtype)
    part = dg.route_parts.get(key)
    if part is None:
        dg.route_parts[key] = _RoutePart()
        return _warm(dg, fn, mask)
    if part.failed:
        profiling.count("depth.route_uncaptured")
        return fn(dg, mask, plain=False)
    if part.graph is None:
        return _capture(part, dg, fn, mask)
    return _replay(part, mask)


def _replayed(fn):
    """``fn`` (a single query's device part that returns device answers)
    through the graph's captured parts (:func:`_route_part`) where the
    graph is on a card, ``plain`` is false and no stream is capturing
    (an outer capture records the eager call); else ``fn`` itself.
    Replayed answers are the graph's own outputs: valid until the next
    call on the same graph and key."""

    @functools.wraps(fn)
    def part(dg: TorchGraph, path_mask, plain: bool = False):
        mask = _as_mask(dg, path_mask)
        if plain or not mask.is_cuda or torch.cuda.is_current_stream_capturing():
            return fn(dg, mask, plain=plain)
        return _route_part(dg, fn, mask)

    return part


_MASKED_PARTS = {
    "ell": seg_depth_with_uniq_ell_parts,
    "cross": _replayed(seg_depth_with_uniq_cross),
    "runs": _replayed(seg_depth_with_uniq_runs_fused),
    # "xla" too takes the scan: the reference's accelerator route.
    "scan": _replayed(seg_depth_with_uniq_fused),
}


def masked_route_fn(dg: TorchGraph) -> Tuple[str, Callable]:
    """The single masked query's route and its device part, called as
    ``fn(dg, path_mask, plain=False)``: int32 (depth, uniq) on the
    graph's device, or the ELL route's per-class parts. On a card the
    cross, scan and runs parts replay a CUDA graph captured once per
    graph, route, mask shape and dtype (:func:`_replayed`): their
    tensors are valid until the next call on the same graph and key."""
    route = _best_masked_impl(dg)
    return route, _MASKED_PARTS.get(route, _MASKED_PARTS["scan"])


def masked_seg_depth(
    dg: TorchGraph, path_mask: torch.Tensor
) -> Tuple[np.ndarray, np.ndarray]:
    """Routed masked (depth, uniq) per segment, as host int32 arrays,
    complete on return. From a CUDA graph they live in page-locked host
    memory that torch's caching host allocator hands to a later call once
    the caller drops them; the process keeps the peak it held at once,
    each block rounded up to a power of two (:func:`_to_host` says how to
    give it back). Spans: ``pollen.depth.single`` around the call; in it
    ``pollen.depth.mask`` (the mask's upload), ``pollen.depth.route``
    (the router), ``pollen.depth.device`` (the route's device part,
    enqueued) and ``pollen.depth.to_host`` (the answers' copies) or, on
    the ELL route, ``pollen.depth.compose``. Counts ``depth.calls``."""
    with profiling.span("pollen.depth.single"):
        with profiling.span("pollen.depth.mask"):
            path_mask = _as_mask(dg, path_mask)
        with profiling.span("pollen.depth.route"):
            route, fn = masked_route_fn(dg)
        profiling.count("depth.calls")
        plain = dg.device.type != "cuda"
        if route == "ell":
            # Composed and un-permuted on the host.
            depth, uniq = seg_depth_with_uniq_ell(dg, path_mask, plain=plain)
            return depth.numpy(), uniq.numpy()
        with profiling.span("pollen.depth.device"):
            depth, uniq = fn(dg, path_mask, plain=plain)
        return tuple(_to_host(depth, uniq))


def batch_route(dg: TorchGraph) -> str:
    """The index a batch of masked queries runs on. Not the single
    query's router: "ell" only when the tiered ELL index is the cheapest
    index; otherwise the crossing matrix whenever one is resident (even
    where a single query would take "runs" or "scan"); then "runs"."""
    if dg.cross_ell.numel() and _best_masked_impl(dg) == "ell":
        return "ell"
    if dg.cross_matrix.numel():
        return "cross"
    return "runs"


def batch_route_fn(dg: TorchGraph) -> Tuple[str, Callable]:
    """The batch's route (:func:`batch_route`) and its device part,
    called as ``fn(dg, path_masks, plain=False)``: int32 (Q, N) pairs on
    the graph's device, or the ELL route's per-class parts."""
    route = batch_route(dg)
    fns = {
        "ell": seg_depth_with_uniq_ell_batch_parts,
        "cross": seg_depth_with_uniq_cross_batch,
        "runs": seg_depth_with_uniq_runs_batch,
    }
    return route, fns[route]


def seg_depth_with_uniq_batch(
    dg: TorchGraph, path_masks: torch.Tensor
) -> Tuple[np.ndarray, np.ndarray]:
    """Many masked queries at once: ``path_masks`` is (Q, P) 0/1;
    returns host int32 (depth, uniq) of shape (Q, N), routed by
    :func:`batch_route`. The serving shape: one resident graph, a
    stream of subset queries. The answers' host memory as
    :func:`masked_seg_depth`'s: page-locked from a CUDA graph, recycled
    once the caller drops them. Spans as :func:`masked_seg_depth`'s,
    under ``pollen.depth.batch``."""
    with profiling.span("pollen.depth.batch"):
        with profiling.span("pollen.depth.mask"):
            path_masks = _as_mask(dg, path_masks)
        with profiling.span("pollen.depth.route"):
            route, fn = batch_route_fn(dg)
        profiling.count("depth.calls")
        plain = dg.device.type != "cuda"
        if route == "ell":
            # Composed on the host ELL_BATCH_CHUNK masks at a time.
            return seg_depth_with_uniq_ell_batch(dg, path_masks, plain=plain)
        with profiling.span("pollen.depth.device"):
            depth, uniq = fn(dg, path_masks, plain=plain)
        return tuple(_to_host(depth, uniq))


def seg_depth_with_uniq_runs_batch(
    dg: TorchGraph, path_masks: torch.Tensor, plain: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch's "runs" route: each mask through the runs route (K8,
    then K7), its answers gathered into int32 (Q, N) on the graph's
    device, one host copy for the batch."""
    path_masks = _as_mask(dg, path_masks)
    q, n = path_masks.shape[0], dg.num_segments
    depth = torch.empty((q, n), dtype=torch.int32, device=dg.device)
    uniq = torch.empty_like(depth)
    for i in range(q):
        depth[i], uniq[i] = seg_depth_with_uniq_runs_fused(
            dg, path_masks[i], plain=plain
        )
    return depth, uniq


def path_depth(dg: TorchGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bp length, bp-weighted depth sum) per path, int64."""
    seg_depth = dg.seg_bounds[1:] - dg.seg_bounds[:-1]
    step_seg = (dg.steps >> 1).long()
    lens = dg.seg_len[step_seg].long()
    weighted = seg_depth[step_seg].long() * lens
    path_len = bounded_segment_sum(lens, dg.path_bounds)
    path_sum = bounded_segment_sum(weighted, dg.path_bounds)
    return path_len, path_sum


# ---------------------------------------------------------------------------
# Host-side emitters (odgi-compatible TSV), as the reference renders them
# ---------------------------------------------------------------------------


def format_float(x: float, digits: int) -> str:
    """odgi-style float: fixed digits, then strip trailing zeros/dot."""
    return f"{x:.{digits}f}".rstrip("0").rstrip(".")


def seg_depth_table(
    g: GraphArrays, depths: np.ndarray, uniqs: np.ndarray
) -> str:
    names = g.seg_name.astype("U20")
    body = [
        f"{n}\t{d}\t{u}"
        for n, d, u in zip(names, np.asarray(depths), np.asarray(uniqs))
    ]
    return "\n".join(["#node.id\tdepth\tdepth.uniq"] + body) + "\n"


def path_depth_table(
    g: GraphArrays,
    lengths: np.ndarray,
    sums: np.ndarray,
    path_ids: Optional[Sequence[int]] = None,
) -> str:
    ids = range(g.num_paths) if path_ids is None else path_ids
    lines = ["#path\tstart\tend\tmean.depth"]
    for i in ids:
        mean = float(sums[i]) / float(lengths[i])
        lines.append(
            f"{g.path_name_bytes(i).decode()}\t0\t{int(lengths[i])}\t"
            f"{format_float(mean, 2)}"
        )
    return "\n".join(lines) + "\n"


def path_mask_for(g: GraphArrays, subset: Sequence[str]) -> np.ndarray:
    wanted = {s.encode() for s in subset}
    return np.array(
        [g.path_name_bytes(i) in wanted for i in range(g.num_paths)],
        dtype=bool,
    )


def run_seg_depth(
    g: GraphArrays,
    dg: TorchGraph,
    subset_paths: Optional[List[str]] = None,
) -> str:
    """End-to-end segment depth query (``depth -d [-s FILE]``): device
    query plus TSV rendering."""
    if subset_paths is None:
        depth, uniq = (t.cpu().numpy() for t in seg_depth_with_uniq(dg))
    else:
        mask = torch.from_numpy(path_mask_for(g, subset_paths))
        depth, uniq = masked_seg_depth(dg, mask)
    return seg_depth_table(g, depth, uniq)


def run_path_depth(
    g: GraphArrays,
    dg: TorchGraph,
    paths: Optional[List[str]] = None,
) -> str:
    lengths, sums = path_depth(dg)
    ids = None
    if paths is not None:
        by_name = {g.path_name_bytes(i): i for i in range(g.num_paths)}
        ids = [by_name[p.encode()] for p in paths if p.encode() in by_name]
    return path_depth_table(
        g, lengths.cpu().numpy(), sums.cpu().numpy(), ids
    )


def run_seg_depth_batch(
    g: GraphArrays,
    dg: TorchGraph,
    subsets: Sequence[Sequence[str]],
) -> str:
    """Many subset-depth queries in one device pass (``depth -S``): one
    TSV table per subset, each preceded by ``##query\t<i>``."""
    if not subsets:
        return ""
    masks = np.stack([path_mask_for(g, s) for s in subsets])
    depth, uniq = seg_depth_with_uniq_batch(dg, torch.from_numpy(masks))
    return "".join(
        f"##query\t{i}\n" + seg_depth_table(g, depth[i], uniq[i])
        for i in range(len(subsets))
    )
