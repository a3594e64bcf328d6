"""Sharded depth/degree: the step list split across the ranks of a job.

A port of pollen_tpu/parallel/sharded.py to ``torch.distributed``. The
reference runs one program over a ``Mesh(hosts, chips)`` under
``shard_map``; here every rank of the job runs the same code on its own
piece (SPMD), over a ``DeviceMesh`` of the same ``("host", "chip")``
shape. Global rank = ``host * chips + chip`` (row-major, as the
reference reshapes its devices), so rank ``d`` holds chunk ``d``, the
position the reference's ``axis_index(STEP_AXES)`` gives it. An output
the reference replicates (``P()``) is the whole vector on every rank;
an output it shards (``P(STEP_AXES)``, ``P("chip")``) is this rank's
slice (:func:`collectives.gather_shards` joins them).

Design, as in the reference: the (segment, path)-sorted step index is
cut into contiguous chunks, one a rank; segment-indexed tables
(N-sized boundaries) are replicated; each rank computes a partial
histogram over its chunk with cumsums and boundary differences, and
the partials are summed across ranks.

``depth.uniq`` (distinct paths per segment) needs a look-back: a
(segment, path) group can straddle chunk bounds, so "first masked step
of the group" needs what lies to the left. Every group is named by its
global start position; each rank all-gathers one (tail-group id, tail-
group masked count) pair and adds the counts of ranks to its left that
end in its head group. One tiny all-gather and one all-reduce per
query. The fused form runs the port's segment scan (K6,
``kernels/segscan.py``) with that carry as a device scalar, so no host
read sits between the all-gather and the kernel.

The column-sharded indexes (crossing matrix, tiered ELL) run with no
collective: each rank holds a contiguous copy of its 128-aligned column
slice and runs the port's kernels on it (K2, K5, K9); the replicated
clip residual is added for the rank's own columns only
(``device.add_residual`` given the rank's first column), as the
single-device routes add it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..device import (
    TorchGraph,
    add_residual,
    compose_ell,
    ell_tiers,
    fold_mid,
    residual_sums,
)
from ..kernels import crossmat as _cm
from ..kernels import ellscan as _ell
from ..kernels import segscan as _ss
from .collectives import all_gather, all_reduce_sum, reduce_scatter_sum

STEP_AXES = ("host", "chip")  # step chunks are sharded over both axes
# The reference's segment-scan block: ``shard_device_graph(dg, mesh,
# block=SCAN_BLOCK)`` lays chunks out as the reference's fused query
# needs them (the port's K6 itself takes any length).
SCAN_BLOCK = 128 * 128


def make_mesh(hosts: Optional[int] = None):
    """A ``(host, chip)`` DeviceMesh over every rank of the job.

    Its device type follows the backend: "cuda" under NCCL, "cpu" under
    gloo, whose groups carry host tensors (collectives.py). ``hosts``
    defaults to 2 when the world is even and larger than 1, as in the
    reference."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if hosts is None:
        hosts = 2 if n % 2 == 0 and n > 1 else 1
    if n % hosts:
        raise ValueError(f"{n} ranks do not split over {hosts} hosts")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (hosts, n // hosts), mesh_dim_names=STEP_AXES)


def mesh_index(mesh) -> int:
    """This rank's chunk: ``host * chips + chip``."""
    host, chip = mesh.get_coordinate()
    return host * mesh.shape[1] + chip


@dataclasses.dataclass
class ShardedGraph:
    """This rank's piece of a step-sharded graph.

    ``step_path_sorted`` and ``run_start`` are the rank's chunk of the
    index padded to ``chunk * ranks`` steps (the reference's global
    arrays, cut in rank order); ``seg_bounds`` and ``chunk_starts`` are
    replicated. Padding uses a sentinel path id (= num_paths) whose
    mask entry is always 0, and each pad step is its own group.
    """

    step_path_sorted: torch.Tensor  # int32[chunk], this rank's chunk
    run_start: torch.Tensor  # int32[chunk] (global positions)
    seg_bounds: torch.Tensor  # int32[N+1] replicated
    chunk_starts: torch.Tensor  # int32[D] replicated: global start of chunk d

    num_segments: int
    num_paths: int
    num_steps: int
    chunk: int
    index: int  # this rank's chunk


def shard_device_graph(dg: TorchGraph, mesh, block: int = 1) -> ShardedGraph:
    """Cut a TorchGraph's sorted index into this rank's chunk.

    ``block``: pad each chunk to a multiple of this (the reference's
    fused query needs :data:`SCAN_BLOCK`); ``chunk`` and
    ``chunk_starts`` equal the reference's for the same ``block``."""
    n_dev = mesh.size()
    d = mesh_index(mesh)
    s = dg.step_path_sorted.shape[0]  # already block-padded by ingest
    chunk = -(-max(s, 1) // (n_dev * block)) * block
    lo, hi = d * chunk, (d + 1) * chunk
    first_pad = min(max(lo, s), hi)  # steps [lo, first_pad) are real
    device = dg.device
    path = torch.cat([
        dg.step_path_sorted[lo:first_pad],
        torch.full((hi - first_pad,), dg.num_paths, dtype=torch.int32,
                   device=device),
    ])
    run_start = torch.cat([
        dg.run_start[lo:first_pad],
        torch.arange(first_pad, hi, dtype=torch.int32, device=device),
    ])
    return ShardedGraph(
        step_path_sorted=path,
        run_start=run_start,
        seg_bounds=dg.seg_bounds,
        chunk_starts=torch.arange(n_dev, dtype=torch.int32, device=device) * chunk,
        num_segments=dg.num_segments,
        num_paths=dg.num_paths,
        num_steps=s,
        chunk=chunk,
        index=d,
    )


def _bounds_diff(
    csum: torch.Tensor, bounds: torch.Tensor, chunk_start: torch.Tensor
) -> torch.Tensor:
    """Per-segment partial sums of one chunk from its inclusive cumsum:
    each segment's global range clipped to the chunk."""
    c = csum.shape[0]
    padded = F.pad(csum, (1, 0))
    lo = (bounds[:-1] - chunk_start).clamp(0, c).long()
    hi = (bounds[1:] - chunk_start).clamp(0, c).long()
    return padded[hi] - padded[lo]


def head_carry(
    tail_key: torch.Tensor,
    tail_count: torch.Tensor,
    head_key: torch.Tensor,
    index: int,
) -> torch.Tensor:
    """The look-back: the masked steps that ranks to this one's left
    hold of its head group (one all-gather of a pair a rank), as a
    0-dim int32 on the device."""
    pairs = all_gather(torch.stack([tail_key, tail_count]))
    keys, counts = pairs[:, 0], pairs[:, 1]
    ranks = torch.arange(pairs.shape[0], device=pairs.device)
    from_left = (ranks < index) & (keys == head_key)
    return (counts * from_left).sum(dtype=torch.int32)


def _local_depth_uniq(
    path_chunk: torch.Tensor,  # int32[C] local sorted step -> path
    run_start: torch.Tensor,  # int32[C] global group starts
    seg_bounds: torch.Tensor,  # int32[N+1] global
    chunk_start: torch.Tensor,  # int32[] global offset of this chunk
    mask_ext: torch.Tensor,  # int32[P+1] path mask with sentinel 0
    index: int,  # this rank's chunk
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank partial (depth, uniq) histograms; the caller sums them."""
    c_size = path_chunk.shape[0]
    w = _ss.lookup_mask(mask_ext, path_chunk)
    csum = torch.cumsum(w, 0, dtype=torch.int32)
    depth_partial = _bounds_diff(csum, seg_bounds, chunk_start)

    # Uniq: masked count within each group, with cross-chunk carry.
    local_start = (run_start - chunk_start).clamp(0, c_size - 1).long()
    excl = csum - w
    within_local = csum - excl[local_start]

    # Tail-group summary for the look-back: the last group's global id
    # and how many masked steps of it live in this chunk.
    carry = head_carry(
        run_start[-1], csum[-1] - excl[local_start[-1]], run_start[0], index
    )
    # Only positions whose group began before this chunk get the carry.
    started_before = run_start < chunk_start
    within = within_local + carry * started_before
    first = w * (within == 1)
    fsum = torch.cumsum(first, 0, dtype=torch.int32)
    return depth_partial, _bounds_diff(fsum, seg_bounds, chunk_start)


Query = Callable[[ShardedGraph, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def sharded_seg_depth_fn(mesh) -> Query:
    """The job-wide (depth, uniq) query.

    The returned function takes this rank's ShardedGraph and an int
    mask of shape [P+1] (last entry 0: the padding sentinel) and
    returns the whole int32[N] depth and uniq vectors on every rank."""

    def query(sg: ShardedGraph, mask_ext: torch.Tensor):
        d, u = _local_depth_uniq(
            sg.step_path_sorted,
            sg.run_start,
            sg.seg_bounds,
            sg.chunk_starts[sg.index],
            mask_ext,
            sg.index,
        )
        total = all_reduce_sum(torch.stack([d, u]))
        return total[0], total[1]

    return query


def sharded_seg_depth_scatter_fn(mesh) -> Query:
    """Job-wide (depth, uniq) with the *output* sharded too.

    Like :func:`sharded_seg_depth_fn`, but the partials are summed over
    the host group and then reduce-scattered over the chip group: each
    rank keeps only its chip's slice of the N-sized result (N padded to
    a multiple of the chip count; the slices of one host row, in chip
    order, are the whole padded vector)."""
    host, chip = mesh.get_group("host"), mesh.get_group("chip")
    chips = mesh.shape[1]

    def query(sg: ShardedGraph, mask_ext: torch.Tensor):
        d, u = _local_depth_uniq(
            sg.step_path_sorted,
            sg.run_start,
            sg.seg_bounds,
            sg.chunk_starts[sg.index],
            mask_ext,
            sg.index,
        )
        both = all_reduce_sum(torch.stack([d, u], dim=1), host)
        pad = (-both.shape[0]) % chips
        both = F.pad(both, (0, 0, 0, pad))
        both = reduce_scatter_sum(both, chip)
        return both[:, 0].contiguous(), both[:, 1].contiguous()

    return query


def sharded_seg_depth_fused_fn(mesh) -> Query:
    """Job-wide (depth, uniq) with the port's segment scan (K6) running
    on each rank's chunk: the sharded form of the "scan" route. Steps:

    1. each rank counts its tail group's masked steps (one reduction),
    2. one tiny all-gather of (tail-group id, count) pairs gives every
       rank its head-group carry, a 0-dim int32 on the device,
    3. K6 runs over the local chunk with that carry as the open group's
       count, so a straddling group's first-selected flag fires on
       exactly one rank (the kernel reads the carry itself: no host
       sync between the all-gather and K6),
    4. local boundary differences, summed with one all-reduce.

    Any chunk length works; ``block=SCAN_BLOCK`` gives the reference's
    layout."""

    def query(sg: ShardedGraph, mask_ext: torch.Tensor):
        csw, csf = _ss.masked_depth_cumsums(*fused_scan_args(sg, mask_ext))
        chunk_start = sg.chunk_starts[sg.index]
        d = _bounds_diff(csw, sg.seg_bounds, chunk_start)
        u = _bounds_diff(csf, sg.seg_bounds, chunk_start)
        total = all_reduce_sum(torch.stack([d, u]))
        return total[0], total[1]

    return query


def fused_scan_args(sg: ShardedGraph, mask_ext: torch.Tensor) -> tuple:
    """Steps 1-2 of the fused query (every rank must call it: it holds
    the all-gather): this rank's K6 arguments ``(path, local run starts,
    mask, head carry)``, the carry a 0-dim int32 on the device."""
    path_chunk, run_start = sg.step_path_sorted, sg.run_start
    w = _ss.lookup_mask(mask_ext, path_chunk)
    tail_key = run_start[-1]
    tail_count = (w * (run_start == tail_key)).sum(dtype=torch.int32)
    carry = head_carry(tail_key, tail_count, run_start[0], sg.index)
    # Kernel inputs are local: left-started groups get negative start
    # positions (never matching a local position).
    local_rs = run_start - sg.chunk_starts[sg.index]
    return path_chunk, local_rs, mask_ext.to(torch.int32), carry


def sharded_degree_fn(mesh):
    """Job-wide degree: link-endpoint chunks sharded, boundary table
    replicated, partial histograms summed with one all-reduce."""

    def query(
        weights: torch.Tensor, chunk_starts: torch.Tensor, bounds: torch.Tensor
    ) -> torch.Tensor:
        csum = torch.cumsum(weights, 0, dtype=torch.int32)
        part = _bounds_diff(csum, bounds, chunk_starts[mesh_index(mesh)])
        return all_reduce_sum(part)

    return query


def shard_degree_inputs(dg: TorchGraph, mesh):
    """(this rank's endpoint weights, chunk starts, replicated bounds)."""
    n_dev = mesh.size()
    total = int(dg.link_seg_bounds[-1])
    chunk = -(-max(total, 1) // n_dev)
    lo = mesh_index(mesh) * chunk
    ones = max(0, min(total - lo, chunk))
    weights = torch.zeros(chunk, dtype=torch.int32, device=dg.device)
    weights[:ones] = 1
    return (
        weights,
        torch.arange(n_dev, dtype=torch.int32, device=dg.device) * chunk,
        dg.link_seg_bounds,
    )


# ---------------------------------------------------------------------------
# Sharded crossing-matrix depth (tensor-parallel over the segment axis)
# ---------------------------------------------------------------------------


def _pad_cols(a: torch.Tensor, n_dev: int, index: int) -> Tuple[torch.Tensor, int]:
    """This rank's slice of a 2-D array's columns, every rank's an
    equal, 128-aligned width (zero columns past the end): returns
    (a contiguous copy of the slice, width per rank)."""
    rows, n_pad = a.shape
    width = -(-n_pad // (n_dev * 128)) * 128
    lo = min(index * width, n_pad)
    hi = min(lo + width, n_pad)
    out = torch.zeros((rows, width), dtype=a.dtype, device=a.device)
    out[:, : hi - lo] = a[:, lo:hi]
    return out, width


class ShardedCross(NamedTuple):
    """This rank's piece of the crossing matrix: its packed columns
    (segments), a contiguous copy; the residual sidecar replicated."""

    cross: torch.Tensor  # packed rows x col_width, this rank's columns
    res: torch.Tensor  # int32[P_pad, K_pad], replicated
    res_seg: torch.Tensor  # int32[K_pad], replicated (sentinel-padded)
    col_width: int  # segment columns per rank
    num_paths_padded: int  # mask length the query expects
    nibble: bool  # two path rows per matrix byte?


def shard_cross_inputs(dg: TorchGraph, mesh) -> Optional[ShardedCross]:
    """Lay the crossing matrix out over the job (see ShardedCross);
    returns None when the graph has no crossing matrix. Column counts
    are padded so every rank gets an equal, 128-aligned slice."""
    if dg.cross_matrix.numel() == 0:
        return None
    rows = dg.cross_matrix.shape[0]
    cross, width = _pad_cols(dg.cross_matrix, mesh.size(), mesh_index(mesh))
    return ShardedCross(
        cross=cross,
        res=dg.cross_res,
        res_seg=dg.cross_res_seg,
        col_width=width,
        num_paths_padded=rows * 2 if dg.cross_nibble else rows,
        nibble=dg.cross_nibble,
    )


def sharded_cross_depth_fn(mesh, nibble: bool = False):
    """Job-wide masked (depth, uniq) over the sharded crossing matrix.

    Each rank runs the crossing-matrix kernel (K2) on its own segment
    columns; outputs stay segment-sharded and NO collective runs (the
    mask is replicated, the residual fix-up is range-filtered
    locally). Exact: integer kernel, int32 residual sums."""
    index = mesh_index(mesh)

    def query(cross, res, res_seg, mask):
        depth, uniq = _cm.masked_cross_depth(cross, mask, nibble=nibble)
        if res_seg.shape[0]:
            fix = residual_sums(res, mask.to(torch.int32))
            depth = add_residual(depth, fix, res_seg, index * cross.shape[1])
        return depth, uniq

    return query


class ShardedEll(NamedTuple):
    """This rank's piece of the tiered split ELL run index: tier slot
    columns, unfolded and un-paired into flat 32-bit slots, and heavy
    nibble columns, each a contiguous copy of the rank's slice; the
    clip residual replicated. Query outputs come back as this rank's
    slices of the per-class part vectors, in the index's permuted order
    (``dg.ell_order`` = [tier1, tier2, tier3, heavy, empty]; the empty
    class needs no device part at all)."""

    ell: torch.Tensor  # int32[K1, light_width]
    ell2: Optional[torch.Tensor]  # int32[K2, mid_width] or None
    ell3: Optional[torch.Tensor]  # int32[K3, mid2_width] or None
    heavy: Optional[torch.Tensor]  # uint8[P_pad/2, heavy_width] or None
    heavy_res: torch.Tensor  # int32[P_pad, K3_pad], replicated
    heavy_res_col: torch.Tensor  # int32[K3_pad], replicated (sentinel-padded)
    light_width: int  # tier-1 columns per rank
    mid_width: int  # tier-2 columns per rank
    mid2_width: int  # tier-3 columns per rank
    heavy_width: int  # heavy columns per rank
    num_paths: int
    nibble_rows: int  # ell_heavy row count (P_pad / 2)


def shard_ell_inputs(dg: TorchGraph, mesh) -> Optional[ShardedEll]:
    """Lay the split ELL run index out over the job (see ShardedEll);
    returns None when the graph has no ELL index."""
    if dg.cross_ell.numel() == 0:
        return None
    n_dev, index = mesh.size(), mesh_index(mesh)

    def _flat(tall, k):
        # The resident layout is tall (sublane-folded); unfold to flat
        # (K, N) slots so columns shard contiguously, and un-pair
        # pack16 storage back to standard slots (K9 reads 32-bit slots).
        f = _ell.unfold_ell_tall(tall, k)
        return _ell.unpair_ell16(f) if dg.ell_pack16 else f

    (e, lw), *mids = [_pad_cols(_flat(t, k), n_dev, index) for t, k in ell_tiers(dg)]
    (ell2, mw), (ell3, m2w) = (mids + [(None, 0)] * 2)[:2]
    heavy, hw, rows = None, 0, 0
    if dg.ell_heavy.numel():
        heavy, hw = _pad_cols(dg.ell_heavy, n_dev, index)
        rows = heavy.shape[0]
    return ShardedEll(
        ell=e,
        ell2=ell2,
        ell3=ell3,
        heavy=heavy,
        heavy_res=dg.ell_heavy_res,
        heavy_res_col=dg.ell_heavy_res_col,
        light_width=lw,
        mid_width=mw,
        mid2_width=m2w,
        heavy_width=hw,
        num_paths=dg.num_paths,
        nibble_rows=rows,
    )


def ell_args(se: ShardedEll, mask: torch.Tensor) -> list:
    """The positional arguments of :func:`sharded_ell_depth_fn` (or of
    the batch form, with (Q, P) masks) for this rank's piece."""
    args = [se.ell]
    args += [t for t in (se.ell2, se.ell3) if t is not None]
    if se.heavy is not None:
        args += [se.heavy, se.heavy_res, se.heavy_res_col]
    return args + [mask]


def _ell_query(has_heavy, has_mid, has_mid2, tiers, heavy_part):
    """The zero-collective ELL query: ``tiers(slots, mask)`` on the list
    of tiers present, then ``heavy_part(h, res, res_col, mask)``."""

    def query(*args):
        mask = args[-1]
        n_tiers = 1 + has_mid + has_mid2
        outs = list(tiers(args[:n_tiers], mask))
        if has_heavy:
            outs += list(heavy_part(*args[n_tiers : n_tiers + 3], mask))
        return tuple(outs)

    return query


def sharded_ell_depth_fn(
    mesh,
    has_heavy: bool = False,
    has_mid: bool = False,
    has_mid2: bool = False,
):
    """Job-wide masked (depth, uniq) over the tiered split ELL run index,
    with the same zero-collective tensor parallelism as the sharded
    crossing matrix: every rank reduces its own tier slot columns on
    the flat ELL kernel (K9, the reference's ``_tier``; all its tiers
    in one launch) and its own heavy nibble columns on the
    crossing-matrix kernel (K2); the
    replicated clip residual is range-filtered locally. Outputs stay
    segment-sharded, one (depth, uniq) pair per present class in
    ``ell_order`` order: (d1, u1[, d2, u2][, d3, u3][, dh, uh])."""
    index = mesh_index(mesh)

    def heavy_part(h, res, res_col, mask):
        mp = _cm.pad_mask(mask, h.shape[0] * 2)
        depth_h, uniq_h = _cm.masked_cross_depth(h, mp, nibble=True)
        if res_col.shape[0]:
            fix = residual_sums(res, mp)
            depth_h = add_residual(depth_h, fix, res_col, index * h.shape[1])
        return depth_h, uniq_h

    return _ell_query(has_heavy, has_mid, has_mid2, _ell.masked_ell_depth_tiers,
                      heavy_part)


def ell_tiers_batch(e: torch.Tensor, masks: torch.Tensor):
    """(depth, uniq) int32[Q, W] of flat 32-bit slots under (Q, P)
    masks, in plain int32 torch (the reference's batched ``_tier_b``
    einsum): one (Q, K, W) mask gather, exact int32 sums."""
    pid = ((e >> _ell.COUNT_BITS) & 0xFFFF).long()
    cnt = e & _ell.COUNT_MAX
    m = torch.zeros((masks.shape[0], 1 << 16), dtype=torch.int32, device=e.device)
    m[:, : masks.shape[1]] = masks.to(torch.int32)
    bit = m[:, pid]
    depth = (bit * cnt).sum(dim=1, dtype=torch.int32)
    uniq = (bit * (e != 0)).sum(dim=1, dtype=torch.int32)
    return depth, uniq


def sharded_ell_depth_batch_fn(
    mesh,
    has_heavy: bool = False,
    has_mid: bool = False,
    has_mid2: bool = False,
):
    """Job-wide BATCHED masked (depth, uniq) over the tiered split ELL
    index: ``masks`` is int[Q, P] (replicated); every rank reduces its
    own tier slot columns for all Q queries at once in plain int32
    torch (:func:`ell_tiers_batch`) and, when present, its heavy nibble
    columns on the batched crossing-matrix kernel (K5); still zero
    collectives, outputs segment-sharded per class with a leading Q
    axis."""
    index = mesh_index(mesh)

    def heavy_part(h, res, res_col, masks):
        mp = _cm.pad_mask(masks, h.shape[0] * 2)
        depth_h, uniq_h = _cm.batched_cross_depth(h, mp, nibble=True)
        if res_col.shape[0]:
            fix = residual_sums(res, mp)
            depth_h = add_residual(depth_h, fix, res_col, index * h.shape[1])
        return depth_h, uniq_h

    def tiers(slots, masks):
        return [x for e in slots for x in ell_tiers_batch(e, masks)]

    return _ell_query(has_heavy, has_mid, has_mid2, tiers, heavy_part)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def compose_ell_parts_natural(
    dg: TorchGraph,
    parts,
    has_mid: bool,
    has_heavy: bool,
    has_mid2: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reassemble a sharded (gathered) or single-device tiered-ELL
    query's per-class part vectors into natural segment order on the
    host, int64: slice each present class to its true size, append the
    empty class's zeros, and invert the ingest permutation ``ell_order``
    (:func:`~pollen_tpu_torch.device.compose_ell`). ``parts`` is the
    flat (d, u) interleaving the sharded query returns: (d1, u1[, d2,
    u2][, d3, u3][, dh, uh])."""
    pairs = [[_host(x) for x in parts[i : i + 2]] for i in range(0, len(parts), 2)]
    n_mid = has_mid + has_mid2
    heavy = pairs[1 + n_mid] if has_heavy else (None, None)
    order = _host(dg.ell_order) if dg.ell_order.shape[0] else None
    d, u = compose_ell(
        dg, (*pairs[0], *fold_mid(dg, pairs[1 : 1 + n_mid]), *heavy), order
    )
    return d.astype(np.int64), u.astype(np.int64)


def full_mask(num_paths: int, device="cpu") -> torch.Tensor:
    """An all-paths mask (with the padding sentinel zeroed)."""
    mask = torch.ones(num_paths + 1, dtype=torch.int32, device=device)
    mask[-1] = 0
    return mask
