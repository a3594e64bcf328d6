"""The resident graph as torch tensors, and its ingest.

``build_graph`` is a jax-free port of the reference ingest
(pollen_tpu/device.py ``build_device_graph``): the (segment, path) sort
and run index, the dense crossing matrix with its residual sidecar, the
tiered split ELL index (tiers, pack16, the heavy nibble block with its
clip residual), the padding of the sorted and run indexes, and the
boundary-plan gates the router reads. Same arrays, same layouts, same
environment knobs (POLLEN_CROSS_BUDGET_MB, POLLEN_ELL_PACK16,
POLLEN_ELL_OBJECTIVE, POLLEN_ELL_SUB); everything is built in numpy
and moved to the device once, at the end.

The readers of that layout sit beside it: ``ell_tiers`` (the tiers
present), ``residual_sums`` and ``add_residual`` (a clip-residual
sidecar's masked sums and their scatter into an answer), ``fold_mid``
and ``compose_ell`` (the ELL classes in ``ell_order``, un-permuted).
Every query, single-device or sharded, reads the index through them.

``TorchGraph`` keeps the fields the depth queries, the router and the
other graph commands read (the degree index ``link_seg_bounds`` too),
under the reference's names. ``from_host_arrays`` turns the fields of a
reference ``DeviceGraph`` built with ``device="host"`` into one, so a
state built by either package can be queried by the port.

The segmented reductions at the end (``boundary_diff``,
``bounded_segment_sum``, ``first_in_group_mask``) are the plain torch
forms of the reference's helpers of the same names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from . import profiling
from .flatgfa import GraphArrays

from .kernels import crossmat as _cm
from .kernels import ellscan as _ell
from .kernels.gatherb import plan_boundary

# Padding block of the sorted and run indexes: the reference pads both
# to its scan kernels' block (pollen_tpu/kernels/segscan.py and
# runscan.py BLOCK = 128 * 128).
SCAN_BLOCK = 128 * 128

TENSOR_FIELDS = (
    "steps",
    "path_bounds",
    "seg_len",
    "step_path_sorted",
    "seg_bounds",
    "run_start",
    "run_path",
    "run_count",
    "run_seg_bounds",
    "link_seg_bounds",
    "cross_matrix",
    "cross_res",
    "cross_res_seg",
    "cross_ell",
    "cross_ell2",
    "cross_ell3",
    "ell_order",
    "ell_heavy",
    "ell_heavy_res",
    "ell_heavy_res_col",
)
META_FIELDS = (
    "num_segments",
    "num_paths",
    "cross_nibble",
    "ell_num_light",
    "ell_num_mid",
    "ell_num_mid2",
    "ell_num_heavy",
    "ell_k",
    "ell_k2",
    "ell_k3",
    "ell_sub",
    "ell_pack16",
    "bnd_w_rows",
    "bnd2_w_rows",
)


@dataclasses.dataclass
class TorchGraph:
    """The queryable graph, resident on one torch device. Field meanings
    follow the reference ``DeviceGraph`` (pollen_tpu/device.py)."""

    steps: torch.Tensor  # int64[S] packed handles (uint32 values)
    path_bounds: torch.Tensor  # int32[P+1]
    seg_len: torch.Tensor  # int32[N]
    step_path_sorted: torch.Tensor  # int32[S_pad]
    seg_bounds: torch.Tensor  # int32[N+1]
    run_start: torch.Tensor  # int32[S_pad]
    run_path: torch.Tensor  # int32[R_pad]
    run_count: torch.Tensor  # int32[R_pad]
    run_seg_bounds: torch.Tensor  # int32[N+1]
    link_seg_bounds: torch.Tensor  # int32[N+1], both link endpoints by segment
    cross_matrix: torch.Tensor  # uint8[P_pad/2, N_pad] | int8[P_pad, N_pad]
    cross_res: torch.Tensor  # int32[P_pad, K_pad] or (0, 0)
    cross_res_seg: torch.Tensor  # int32[K_pad]
    cross_ell: torch.Tensor  # int32[G1*K1*SUB, TALL_W] or (0, 0)
    cross_ell2: torch.Tensor  # int32[G2*K2*SUB, TALL_W] or (0, 0)
    cross_ell3: torch.Tensor  # int32[G3*K3*SUB, TALL_W] or (0, 0)
    ell_order: torch.Tensor  # int32[N] or (0,)
    ell_heavy: torch.Tensor  # uint8[P_pad/2, NH_pad] or (0, 0)
    ell_heavy_res: torch.Tensor  # int32[P_pad, K3_pad] or (0, 0)
    ell_heavy_res_col: torch.Tensor  # int32[K3_pad]

    num_segments: int
    num_paths: int
    cross_nibble: bool = False
    ell_num_light: int = 0
    ell_num_mid: int = 0
    ell_num_mid2: int = 0
    ell_num_heavy: int = 0
    ell_k: int = 0  # stored words per column (two slots each under pack16)
    ell_k2: int = 0
    ell_k3: int = 0
    ell_sub: int = 0
    ell_pack16: int = 0
    bnd_w_rows: int = 0
    bnd2_w_rows: int = 0
    # The single query's captured device parts (ops.depth._route_part),
    # filled on a card and freed with the graph; a copy made with
    # dataclasses.replace starts with none.
    route_parts: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def num_steps(self) -> int:
        return self.steps.shape[0]

    @property
    def padded_steps(self) -> int:
        return self.step_path_sorted.shape[0]

    @property
    def device(self) -> torch.device:
        return self.seg_bounds.device

    def to(self, device) -> "TorchGraph":
        device = resolve_device(device)
        moved = {f: getattr(self, f).to(device) for f in TENSOR_FIELDS}
        return dataclasses.replace(self, **moved)


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device with no card is an
    error, never a quiet CPU run."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is available"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def op_tensor(x, device, dtype=None, move: bool = False) -> torch.Tensor:
    """An array argument of a public op as a tensor on ``device``, the
    device the op runs on, converted once at the op's entry. A host array
    (numpy, as the reference's jitted ops take it) becomes a ``dtype``
    tensor there, uint32 values (packed handles) by their int32 bits when
    ``dtype`` is int32. A tensor is taken as it is; one on another device
    is refused, since moving it would be a copy inside the op, unless
    ``move`` (the depth queries' masks and ``positions_in_path``'s
    offsets, which those ops have always moved to the graph, cast to
    ``dtype``)."""
    device = torch.device(device)
    if isinstance(x, torch.Tensor):
        if move:
            return x.to(device=device, dtype=dtype)
        if x.device != device:
            raise ValueError(f"an argument on {x.device}, the op runs on {device}")
        return x
    x = np.asarray(x)
    if x.dtype == np.uint32 and dtype == torch.int32:
        x = x.view(np.int32)
    return torch.as_tensor(x, dtype=dtype, device=device)


def _tensor(x: np.ndarray, device: torch.device) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.from_numpy(x).to(device)


def from_host_arrays(fields: dict, device) -> TorchGraph:
    """A ``TorchGraph`` from the reference's host-built ``DeviceGraph``
    fields (``{f.name: getattr(dg, f.name) for f in
    dataclasses.fields(dg)}``); fields the port does not read are
    dropped."""
    device = resolve_device(device)
    return TorchGraph(
        **{f: _tensor(np.asarray(fields[f]), device) for f in TENSOR_FIELDS},
        **{f: fields[f] for f in META_FIELDS},
    )


def build_graph(
    g: GraphArrays,
    device,
    minimal: bool = False,
    cross_matrix: str = "auto",
    ell_objective: str | None = None,
) -> TorchGraph:
    """Ingest an arena and move the index to ``device``.

    ``minimal=True`` leaves out the pools only other queries read.
    ``cross_matrix``: "auto" builds the dense crossing matrix and the
    ELL index when they fit POLLEN_CROSS_BUDGET_MB (default 256);
    "always" / "never" override. ``ell_objective``: "single" (default,
    or POLLEN_ELL_OBJECTIVE) plans for single-query latency, "batch"
    for batched serving.

    The span ``pollen.ingest`` covers the build; its stages are spans
    of their own (``pollen.ingest.sort``, ``.runs``, ``.cross``,
    ``.ell``, ``.tables``, ``.to_device``) whose seconds add to the
    counters ``ingest.<stage>.s`` whether spans record or not, beside
    ``ingest.builds``."""
    device = resolve_device(device)
    with profiling.span("pollen.ingest"):
        arrays, meta = _host_index(g, minimal, cross_matrix, ell_objective)
        with _stage("to_device"):
            tensors = {k: _tensor(v, device) for k, v in arrays.items()}
    profiling.count("ingest.builds")
    return TorchGraph(**tensors, **meta)


@contextlib.contextmanager
def _stage(name: str):
    """A stage of ``build_graph``: span ``pollen.ingest.<name>``, its
    seconds added to the counter ``ingest.<name>.s`` whether spans
    record or not."""
    t0 = time.perf_counter()
    with profiling.span(f"pollen.ingest.{name}"):
        yield
    profiling.count(f"ingest.{name}.s", time.perf_counter() - t0)


def _host_index(g, minimal, cross_matrix, ell_objective):
    """``build_graph``'s host stages: (numpy arrays by field, meta
    fields)."""
    n, p, s = g.num_segments, g.num_paths, g.num_steps

    with _stage("sort"):
        step_seg = g.step_segs
        step_path = g.step_path_ids()
        perm = np.lexsort((step_path, step_seg)).astype(np.int32)
        seg_sorted = step_seg[perm]
        path_sorted = step_path[perm]
        seg_bounds = np.searchsorted(
            seg_sorted, np.arange(n + 1, dtype=np.int32)
        ).astype(np.int32)

    with _stage("runs"):
        # (segment, path) group starts and the run-level index.
        if s:
            new_run = np.empty(s, dtype=bool)
            new_run[0] = True
            new_run[1:] = (seg_sorted[1:] != seg_sorted[:-1]) | (
                path_sorted[1:] != path_sorted[:-1]
            )
            starts = np.flatnonzero(new_run).astype(np.int32)
            run_count = np.diff(np.concatenate([starts, [s]])).astype(np.int32)
            run_start = np.repeat(starts, run_count)
            run_path = path_sorted[starts]
            run_seg_bounds = np.searchsorted(
                seg_sorted[starts], np.arange(n + 1, dtype=np.int32)
            ).astype(np.int32)
        else:
            starts = np.zeros(0, dtype=np.int32)
            run_start = np.zeros(0, dtype=np.int32)
            run_path = np.zeros(0, dtype=np.int32)
            run_count = np.zeros(0, dtype=np.int32)
            run_seg_bounds = np.zeros(n + 1, dtype=np.int32)
        run_seg = seg_sorted[starts]

    with _stage("cross"):
        # Dense crossing matrix, nibble or int8, whichever is smaller with
        # its residual sidecar.
        lanes = _cm.LANES
        p_pad_m = -(-max(p, 1) // lanes) * lanes
        n_pad_m = -(-max(n, 1) // lanes) * lanes
        budget = float(os.environ.get("POLLEN_CROSS_BUDGET_MB", "256")) * 2**20
        build_cross = s > 0 and p > 0 and n > 0 and cross_matrix != "never"

        def _sidecar_cols(clip: int):
            over = np.flatnonzero(run_count > clip)
            segs = np.unique(run_seg[over])
            k_pad = -(-segs.size // lanes) * lanes if segs.size else 0
            return over, segs, k_pad

        over_n, segs_n, k_n = _sidecar_cols(_cm.CLIP_NIBBLE)
        over_8, segs_8, k_8 = _sidecar_cols(_cm.CLIP)
        nib_bytes = (p_pad_m // 2) * n_pad_m + p_pad_m * k_n * 4
        i8_bytes = p_pad_m * n_pad_m + p_pad_m * k_8 * 4
        use_nibble = nib_bytes <= i8_bytes
        if cross_matrix == "auto" and min(nib_bytes, i8_bytes) > budget:
            build_cross = False
        if build_cross:
            clip = _cm.CLIP_NIBBLE if use_nibble else _cm.CLIP
            over, segs, k_pad = (
                (over_n, segs_n, k_n) if use_nibble else (over_8, segs_8, k_8)
            )
            counts = np.minimum(run_count, clip)
            if use_nibble:
                cross = _nibble_pack(run_path, run_seg, counts, p_pad_m, n_pad_m)
            else:
                cross = np.zeros((p_pad_m, n_pad_m), np.int8)
                cross[run_path, run_seg] = counts.astype(np.int8)
            cross_res = np.zeros((p_pad_m, k_pad), np.int32)
            cross_res_seg = np.full(k_pad, _cm.RES_SENTINEL, np.int32)
            if k_pad:
                col = np.searchsorted(segs, run_seg[over])
                cross_res[run_path[over], col] = run_count[over] - clip
                cross_res_seg[: segs.size] = segs
        else:
            use_nibble = False
            cross = np.zeros((0, 0), np.int8)
            cross_res = np.zeros((0, 0), np.int32)
            cross_res_seg = np.zeros(0, np.int32)

    with _stage("ell"):
        # Tiered split ELL index: tiers of K slots per column, the heaviest
        # segments in a nibble block, never-crossed segments in no class;
        # outputs come back in ell_order = [tier1, tier2, tier3, heavy, empty].
        ell = ell2 = ell3 = np.zeros((0, 0), np.int32)
        ell_order = np.zeros(0, np.int32)
        ell_heavy = np.zeros((0, 0), np.uint8)
        ell_heavy_res = np.zeros((0, 0), np.int32)
        ell_heavy_res_col = np.zeros(0, np.int32)
        ell_nl, ell_nm, ell_nm2, ell_nh = n, 0, 0, 0
        k_ell = k_ell2 = k_ell3 = 0
        ell_sub_v = 0
        ell_pack16_v = 0
        if s > 0 and 0 < p < (1 << 16) and n > 0 and cross_matrix != "never":
            runs_per_seg = np.bincount(run_seg, minlength=n)
            big_seg = np.zeros(n, bool)
            big_seg[run_seg[run_count > _ell.COUNT_MAX]] = True
            if ell_objective is None:
                ell_objective = os.environ.get("POLLEN_ELL_OBJECTIVE", "single")
            # pack16 (two path<<8|count halves per word) for <= 256 paths on
            # single-query plans; segments with a count > 255 go heavy.
            use_pack16 = (
                p <= 256
                and ell_objective != "batch"
                and os.environ.get("POLLEN_ELL_PACK16", "1") == "1"
            )
            if use_pack16:
                big_seg[run_seg[run_count > 255]] = True
            ks, tier_masks, heavy_b = _ell.plan_ell_tiers_n(
                runs_per_seg, big_seg, p_pad_m, objective=ell_objective
            )
            tier_ids = [np.flatnonzero(t).astype(np.int32) for t in tier_masks]
            heavy_ids = np.flatnonzero(heavy_b).astype(np.int32)
            not_empty = heavy_b.copy()
            for t in tier_masks:
                not_empty |= t
            empty_ids = np.flatnonzero(~not_empty).astype(np.int32)
            tier_counts = [ids.size for ids in tier_ids]
            nh = heavy_ids.size
            nh_blk = _cm.SEG_BLOCK if nh >= _cm.SEG_BLOCK else lanes
            nh_pad = -(-nh // nh_blk) * nh_blk if nh else 0
            hv = heavy_b[run_seg]
            over_h = hv & (run_count > _cm.CLIP_NIBBLE)
            over_cols = np.unique(run_seg[over_h])
            k3 = -(-over_cols.size // lanes) * lanes if over_cols.size else 0
            tile = _ell.SUB * _ell.TALL_W

            def tall_pad(c: int) -> int:
                return -(-max(c, 1) // tile) * tile if c else 0

            # Budget against the resident sizes (tall padding, pack16 words),
            # after what the dense matrix already spent.
            ell_bytes = (
                sum(
                    4 * ((k + 1) // 2 if use_pack16 else k) * tall_pad(c)
                    for k, c in zip(ks, tier_counts)
                )
                + (p_pad_m // 2) * nh_pad
                + 4 * p_pad_m * k3
            )
            spent = cross.nbytes + cross_res.nbytes if build_cross else 0
            if ks and (cross_matrix == "always" or ell_bytes <= budget - spent):
                seg_starts = np.concatenate(([0], np.cumsum(runs_per_seg)))
                slot = np.arange(run_seg.size, dtype=np.int64) - seg_starts[run_seg]

                def store_tier(t_b, k, cols):
                    """Pack one tier; returns (slots, STORED word count)."""
                    seg_to_col = np.cumsum(t_b) - 1
                    v = t_b[run_seg]
                    e = _ell.pack_ell(
                        run_path[v], run_count[v], seg_to_col[run_seg[v]],
                        slot[v], k, max(cols, 1),
                    )
                    if use_pack16:
                        return _ell.pair_ell16(e), (k + 1) // 2
                    return e, k

                ell, k_ell = store_tier(tier_masks[0], ks[0], tier_counts[0])
                ell_sub_v = _ell.SUB
                ell_pack16_v = 1 if use_pack16 else 0
                if len(ks) > 1:
                    ell2, k_ell2 = store_tier(tier_masks[1], ks[1], tier_counts[1])
                if len(ks) > 2:
                    ell3, k_ell3 = store_tier(tier_masks[2], ks[2], tier_counts[2])
                ell_nl = tier_counts[0]
                ell_nm = tier_counts[1] if len(ks) > 1 else 0
                ell_nm2 = tier_counts[2] if len(ks) > 2 else 0
                ell_nh = nh
                if ell_nm or ell_nm2 or nh or empty_ids.size:
                    # Heavy columns with clip overflow come first, so the
                    # residual add is a prefix slice-add.
                    if nh and over_cols.size:
                        rest = heavy_ids[~np.isin(heavy_ids, over_cols)]
                        heavy_ids = np.concatenate(
                            [over_cols.astype(np.int32), rest]
                        )
                    ell_order = np.concatenate(tier_ids + [heavy_ids, empty_ids])
                if nh:
                    seg_to_heavy = np.zeros(n, np.int64)
                    seg_to_heavy[heavy_ids] = np.arange(nh)
                    h_counts = np.minimum(run_count[hv], _cm.CLIP_NIBBLE)
                    ell_heavy = _nibble_pack(
                        run_path[hv], seg_to_heavy[run_seg[hv]], h_counts,
                        p_pad_m, nh_pad,
                    )
                    if k3:
                        ell_heavy_res = np.zeros((p_pad_m, k3), np.int32)
                        ell_heavy_res_col = np.full(
                            k3, _cm.RES_SENTINEL, np.int32
                        )
                        colr = np.searchsorted(over_cols, run_seg[over_h])
                        ell_heavy_res[run_path[over_h], colr] = (
                            run_count[over_h] - _cm.CLIP_NIBBLE
                        )
                        ell_heavy_res_col[: over_cols.size] = seg_to_heavy[
                            over_cols
                        ]

        if ell.size:
            ell = _ell.pack_ell_tall(ell)
            if ell2.size:
                ell2 = _ell.pack_ell_tall(ell2)
            if ell3.size:
                ell3 = _ell.pack_ell_tall(ell3)

    with _stage("tables"):
        # Pad the sorted and run indexes: pad entries carry path id p (masked
        # to 0) and zero counts, beyond every boundary table.
        s_pad = -(-max(s, 1) // SCAN_BLOCK) * SCAN_BLOCK
        path_sorted = np.concatenate([path_sorted, np.full(s_pad - s, p, np.int32)])
        run_start = np.concatenate(
            [run_start, np.arange(s, s_pad, dtype=np.int32)]
        )
        r = run_path.shape[0]
        r_pad = -(-max(r, 1) // SCAN_BLOCK) * SCAN_BLOCK
        run_path = np.concatenate([run_path, np.full(r_pad - r, p, np.int32)])
        run_count = np.concatenate([run_count, np.zeros(r_pad - r, np.int32)])

        # Boundary-plan gates the router reads (the port's boundary kernel
        # reads the bounds themselves and needs no plan arrays).
        bnd_w_rows = _plan_rows(
            seg_bounds, s_pad, s_pad < (1 << 24) and n > 0
        )
        bnd2_w_rows = _plan_rows(
            run_seg_bounds,
            r_pad,
            not minimal and r_pad < (1 << 24) and n > 0 and r > 0,
        )

        path_bounds = np.concatenate(
            ([0], np.cumsum(g.path_steps[:, 1] - g.path_steps[:, 0]))
        ).astype(np.int32)

        # Degree index: both link endpoints, histogrammed by segment.
        endpoints = np.concatenate(
            [(g.link_from >> 1).astype(np.int32), (g.link_to >> 1).astype(np.int32)]
        )
        endpoints.sort()
        link_seg_bounds = np.searchsorted(
            endpoints, np.arange(n + 1, dtype=np.int32)
        ).astype(np.int32)

        empty32 = np.zeros(0, np.int32)
        arrays = dict(
            steps=g.steps if not minimal else empty32,
            path_bounds=path_bounds,
            seg_len=g.seg_len.astype(np.int32) if not minimal else empty32,
            step_path_sorted=path_sorted,
            seg_bounds=seg_bounds,
            run_start=run_start,
            run_path=run_path if not minimal else empty32,
            run_count=run_count if not minimal else empty32,
            run_seg_bounds=run_seg_bounds,
            link_seg_bounds=link_seg_bounds,
            cross_matrix=cross,
            cross_res=cross_res,
            cross_res_seg=cross_res_seg,
            cross_ell=ell,
            cross_ell2=ell2,
            cross_ell3=ell3,
            ell_order=ell_order,
            ell_heavy=ell_heavy,
            ell_heavy_res=ell_heavy_res,
            ell_heavy_res_col=ell_heavy_res_col,
        )
    meta = dict(
        num_segments=n,
        num_paths=p,
        cross_nibble=use_nibble,
        ell_num_light=ell_nl,
        ell_num_mid=ell_nm,
        ell_num_mid2=ell_nm2,
        ell_num_heavy=ell_nh,
        ell_k=k_ell,
        ell_k2=k_ell2,
        ell_k3=k_ell3,
        ell_sub=ell_sub_v,
        ell_pack16=ell_pack16_v,
        bnd_w_rows=bnd_w_rows,
        bnd2_w_rows=bnd2_w_rows,
    )
    return arrays, meta


def _nibble_pack(path, col, counts, p_pad, n_cols):
    """Counts (<= 15) -> uint8[p_pad/2, n_cols]: path 2r in the low
    nibble of row r, path 2r+1 in the high nibble. (path, col) pairs are
    unique, so the odd-path read-or-write never collides."""
    out = np.zeros((p_pad // 2, n_cols), np.uint8)
    even = (path & 1) == 0
    out[path[even] >> 1, col[even]] = counts[even].astype(np.uint8)
    odd = ~even
    out[path[odd] >> 1, col[odd]] |= counts[odd].astype(np.uint8) << 4
    return out


def _plan_rows(bounds: np.ndarray, s_pad: int, eligible: bool) -> int:
    """The boundary plan's window rows, or 0 where the reference keeps
    no plan (ineligible, or more than 64 overflow tiles)."""
    if not eligible:
        return 0
    plan = plan_boundary(bounds, s_pad)
    return plan.w_rows if len(plan.over_tiles) <= 64 else 0


# ---------------------------------------------------------------------------
# Readers of the layout build_graph writes: the ELL tiers, the clip
# residual sidecars and the class order. Every query reads it here.
# ---------------------------------------------------------------------------


def ell_tiers(dg: TorchGraph) -> list:
    """The resident tall ELL tiers as ``[(tall, stored words), ...]`` in
    tier order: tier 1, then tiers 2 and 3 where present (the planner
    fills tiers in order, so a third tier comes only with a second)."""
    tiers = [(dg.cross_ell, dg.ell_k)]
    for tall, k in ((dg.cross_ell2, dg.ell_k2), (dg.cross_ell3, dg.ell_k3)):
        if tall.numel():
            tiers.append((tall, k))
    return tiers


def residual_sums(res: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Column sums of an int32[P_pad, K] clip-residual sidecar
    (``cross_res``, ``ell_heavy_res``) under one 0/1 mask (P_pad,) ->
    int32 (K,), or under (Q, P_pad) masks -> int32 (Q, K). Exact: one
    mask in int32; many as a float64 matmul, whose products and sums of
    integers stay far below 2^53 (torch.matmul has no int32 CUDA form)."""
    if masks.dim() == 1:
        return (res * masks[:, None]).sum(dim=0, dtype=torch.int32)
    return (masks.to(torch.float64) @ res.to(torch.float64)).to(torch.int32)


def add_residual(
    out: torch.Tensor, fix: torch.Tensor, cols: torch.Tensor, lo: int = 0
) -> torch.Tensor:
    """``out`` (columns on its last axis, a leading Q axis or none) plus
    the residual sums ``fix`` (:func:`residual_sums`) at the sidecar's
    column ids ``cols`` (``cross_res_seg``, ``ell_heavy_res_col``), less
    ``lo``, a rank's first column where ``out`` is that rank's slice: a
    new tensor. A column outside ``out`` adds nothing: the sentinel
    padding (``RES_SENTINEL``) and other ranks' columns are masked out
    explicitly, since torch's scatter has no drop mode and a negative
    index would wrap."""
    local = cols - lo if lo else cols
    own = (local >= 0) & (local < out.shape[-1])
    idx = torch.where(own, local, 0).long()
    return out.index_add(out.dim() - 1, idx, fix * own)


def _cat(pieces: list):
    """Concatenate on the last axis: host numpy arrays or tensors."""
    if isinstance(pieces[0], torch.Tensor):
        return torch.cat(pieces, dim=-1)
    return np.concatenate(pieces, axis=-1)


def fold_mid(dg: TorchGraph, tier_parts: list) -> tuple:
    """Tiers 2 and 3's (depth, uniq) pairs (columns on the last axis) as
    the one mid class pair: tier 2's first ``ell_num_mid`` columns, then
    tier 3's first ``ell_num_mid2``; a lone tier's pair as it is; (None,
    None) with neither."""
    if len(tier_parts) < 2:
        return tuple(tier_parts[0]) if tier_parts else (None, None)
    (d2, u2), (d3, u3) = tier_parts
    nm, nm2 = dg.ell_num_mid, dg.ell_num_mid2
    return (_cat([d2[..., :nm], d3[..., :nm2]]),
            _cat([u2[..., :nm], u3[..., :nm2]]))


def compose_ell(dg: TorchGraph, parts, order=None) -> tuple:
    """The tiered ELL index's class parts ``(d1, u1, d2, u2, dh, uh)``
    (tier 1, the mid class of :func:`fold_mid`, heavy; None where
    absent; columns on the last axis, a leading Q axis or none) as one
    (depth, uniq) pair over the N segments: each class cut to its
    ``ell_num_*`` columns, in ``ell_order``, then the empty class's
    zeros; un-permuted into natural segment order by ``order``, the
    host copy of ``ell_order``, where given. Host numpy arrays or
    tensors of one device, in the parts' dtype."""
    counts = (dg.ell_num_light, dg.ell_num_mid + dg.ell_num_mid2,
              dg.ell_num_heavy)
    if order is not None:
        inv = np.empty(dg.num_segments, np.int64)
        inv[order] = np.arange(dg.num_segments)
    out = []
    for xs in (parts[0::2], parts[1::2]):
        present = [(x, c) for x, c in zip(xs, counts) if x is not None]
        pieces = [x[..., :c] for x, c in present]
        first = pieces[0]
        shape = first.shape[:-1] + (dg.num_segments - sum(c for _, c in present),)
        if isinstance(first, torch.Tensor):
            pieces.append(first.new_zeros(shape))
        else:
            pieces.append(np.zeros(shape, first.dtype))
        whole = _cat(pieces)
        out.append(whole if order is None else whole[..., inv])
    return tuple(out)


# ---------------------------------------------------------------------------
# Segmented reductions over the sorted indexes (plain torch; the
# reference's pollen_tpu/device.py helpers of the same names)
# ---------------------------------------------------------------------------


def boundary_values(csum: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """``exclusive_csum[bounds]``: ``csum[b - 1]``, and 0 where b == 0.
    A bound may equal ``csum``'s length."""
    padded = torch.cat([csum.new_zeros(1), csum])
    return padded[bounds.long()]


def boundary_diff(csum: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Per-range sums of the sequence whose inclusive cumsum is
    ``csum``, for contiguous ranges [bounds[i], bounds[i+1])."""
    v = boundary_values(csum, bounds)
    return v[1:] - v[:-1]


def bounded_segment_sum(
    weights: torch.Tensor, bounds: torch.Tensor
) -> torch.Tensor:
    """Sum ``weights`` within each [bounds[i], bounds[i+1]) range (the
    ranges contiguous in ``weights``' order): one cumsum, one boundary
    difference, in the weights' own dtype."""
    return boundary_diff(torch.cumsum(weights, 0, dtype=weights.dtype), bounds)


def first_in_group_mask(
    weights: torch.Tensor, run_start: torch.Tensor
) -> torch.Tensor:
    """1 where a nonzero weight is the first nonzero of its group, the
    groups being the contiguous runs that start at ``run_start``;
    int32. Counting these per segment counts distinct paths (uniq)."""
    w = (weights != 0).to(torch.int32)
    csum = torch.cumsum(w, 0, dtype=torch.int32)
    excl = csum - w
    within = csum - excl[run_start.long()]
    return w * (within == 1).to(torch.int32)
