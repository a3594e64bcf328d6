"""ELL-packed run index: host packing and the masked tier reductions.

The run-level index stored ELLPACK-style: ``K`` slots per segment
column, each an int32 ``path << 16 | count`` (or, for at most 256
paths, two 16-bit ``path << 8 | count`` halves per word: pack16), in
the tall layout ``tall[(g*K + k)*SUB + r, c]``. The masked query is

    depth[s] = sum_k  mask[path(v_ks)] * count(v_ks)
    uniq[s]  = sum_k  mask[path(v_ks)] * (v_ks != 0)

Host half: a jax-free port of pollen_tpu/kernels/ellscan.py's planner
and packers (same constants, same layouts), so the port builds the
resident index the reference builds; also the flat ``(K, N_pad)``
single-tier layout (:func:`build_ell`), which only direct kernel
callers use. Device half: the wrappers of the CUDA kernels in
``csrc/depth.cu`` (one mask) and ``csrc/depth_batch.cu`` (Q masks in
one launch) beside their plain PyTorch versions.
A wrapper runs the plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import itertools
import os
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build

LANES = 128
COUNT_BITS = 16
COUNT_MAX = (1 << COUNT_BITS) - 1

# Router and planner constants, unchanged from the reference (TPU fits,
# pollen_tpu/kernels/ellscan.py): the port routes and plans as the
# reference does until H100 constants are measured.
C_COL_B = 5.25
C_HEAVY_PER_PATH = 0.74
C_HEAVY_PER_BYTE = 2 * C_HEAVY_PER_PATH
C_TIER_FIXED = 1.3e6
ELL_BATCH_Q = 32

# Tall layout: SUB column tiles of TALL_W folded into rows.
SUB = int(os.environ.get("POLLEN_ELL_SUB", "8"))
TALL_W = 4096

# Launch counts of the CUDA kernels (plain-version calls do not count).
launches = {"ell_tier": 0, "ell_splitn": 0, "ell_splitn_batch": 0, "ell_flat": 0}


def c_slot_a(n_words: int = 4) -> float:
    """Marginal per-slot cost of a tier (reference fit)."""
    return 1.15 + 0.7 * max(n_words - 1, 1)


def plan_ell_tiers_n(
    runs_per_seg: np.ndarray,
    big_seg: np.ndarray,
    p_pad: int,
    max_tiers: int = 3,
    objective: str = "single",
):
    """Up to ``max_tiers`` ELL tiers (K_1 < K_2 < ...) plus a dense heavy
    class, chosen by the reference's cost model. Returns
    ``(ks, tier_masks, heavy_mask)``; never-crossed segments are in no
    class. ``ks`` is empty when no crossed segment fits any K."""
    crossed = runs_per_seg > 0
    valid = ~big_seg & crossed
    tile = SUB * TALL_W

    def pad(n: int) -> int:
        return -(-n // tile) * tile if n else 0

    n_crossed = int(crossed.sum())
    n_words = max(-(-p_pad // 32), 1)
    a = c_slot_a(n_words)
    if objective == "single":
        tier_fixed = C_TIER_FIXED
        heavy_per_col = C_HEAVY_PER_PATH * p_pad
    else:
        tier_fixed = C_TIER_FIXED / ELL_BATCH_Q
        heavy_per_col = C_HEAVY_PER_PATH * p_pad / ELL_BATCH_Q + 8
    kset = (1, 2, 4, 8, 16, 32)
    c_le = {k: int((valid & (runs_per_seg <= k)).sum()) for k in kset}
    best = None
    for size in range(1, max_tiers + 1):
        for ks in itertools.combinations(kset, size):
            counts = []
            prev_le = 0
            for k in ks:
                n_t = c_le[k] - prev_le
                if n_t == 0:
                    break  # equivalent to a smaller subset
                counts.append(n_t)
                prev_le = c_le[k]
            else:
                nh = n_crossed - sum(counts)
                cost = sum(
                    tier_fixed + (a * k + C_COL_B) * pad(n_t)
                    for k, n_t in zip(ks, counts)
                )
                if nh:
                    cost += tier_fixed + heavy_per_col * nh
                if best is None or cost < best[0]:
                    best = (cost, ks)
    if best is None:
        return (), [], crossed.copy()
    _, ks = best
    masks = []
    prev = np.zeros_like(valid)
    for k in ks:
        t = valid & (runs_per_seg <= k) & ~prev
        masks.append(t)
        prev = prev | t
    return ks, masks, crossed & ~prev


def plan_ell_tiers(runs_per_seg: np.ndarray, big_seg: np.ndarray, p_pad: int):
    """Two-tier form of :func:`plan_ell_tiers_n`: ``(k1, k2, tier1_mask,
    tier2_mask, heavy_mask)``, ``k2 == 0`` with an all-false tier 2 when
    a middle tier does not pay."""
    ks, masks, heavy = plan_ell_tiers_n(runs_per_seg, big_seg, p_pad, max_tiers=2)
    empty = np.zeros_like(heavy)
    if not ks:
        return 1, 0, empty, empty, heavy
    if len(ks) == 1:
        return ks[0], 0, masks[0], empty, heavy
    return ks[0], ks[1], masks[0], masks[1], heavy


def plan_ell(runs_per_seg: np.ndarray, big_seg: np.ndarray, p_pad: int):
    """``(k, heavy)`` for the flat single-tier layout: K in {1, 2, 4, 8,
    16} minimizing ``4 K`` bytes per light column plus ``p_pad / 2`` per
    heavy one; a segment is heavy when its runs overflow K slots or a
    count overflows 16 bits (``big_seg``)."""
    best = None
    for k in (1, 2, 4, 8, 16):
        heavy = (runs_per_seg > k) | big_seg
        nh = int(heavy.sum())
        nl = runs_per_seg.shape[0] - nh
        nl_pad = -(-max(nl, 1) // LANES) * LANES
        nh_pad = -(-nh // LANES) * LANES if nh else 0
        cost = 4 * k * nl_pad + (p_pad // 2) * nh_pad
        if best is None or cost < best[0]:
            best = (cost, k, heavy)
    return best[1], best[2]


def build_ell(
    run_path: np.ndarray,
    run_count: np.ndarray,
    run_seg: np.ndarray,
    num_segments: int,
    k: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """``(ell, heavy_segs)``: the runs packed into flat int32[K, N_pad]
    ``path << 16 | count`` slots over ALL segments, heavy columns left
    empty, and the heavy segments' ids. K from :func:`plan_ell` unless
    given (P is read as ``run_path.max() + 1``: leave out padding runs).
    Runs must arrive grouped by segment."""
    n_pad = -(-max(num_segments, 1) // LANES) * LANES
    runs_per_seg = np.bincount(run_seg, minlength=num_segments)
    big_seg = np.zeros(num_segments, bool)
    big_seg[run_seg[run_count > COUNT_MAX]] = True
    if k is None:
        p = int(run_path.max(initial=0)) + 1
        p_pad = -(-max(p, 1) // LANES) * LANES
        k, heavy_b = plan_ell(runs_per_seg, big_seg, p_pad)
    else:
        heavy_b = (runs_per_seg > k) | big_seg
    heavy = np.flatnonzero(heavy_b).astype(np.int32)
    seg_starts = np.concatenate(([0], np.cumsum(runs_per_seg)))
    slot = np.arange(run_seg.size, dtype=np.int64) - seg_starts[run_seg]
    keep = ~heavy_b[run_seg]
    ell = pack_ell(
        run_path[keep], run_count[keep], run_seg[keep], slot[keep], k, n_pad
    )
    return ell, heavy


def pack_ell(
    run_path: np.ndarray,
    run_count: np.ndarray,
    run_col: np.ndarray,
    slot: np.ndarray,
    k: int,
    n_cols_pad: int,
) -> np.ndarray:
    """Runs -> int32[K, n_cols_pad] ``path << 16 | count`` slots (empty
    slots 0); each run's slot must be < K and its count <= COUNT_MAX."""
    ell = np.zeros((k, n_cols_pad), np.int32)
    ell[slot, run_col] = (
        run_path.astype(np.int32) << COUNT_BITS
    ) | run_count.astype(np.int32)
    return ell


def pair_ell16(ell: np.ndarray) -> np.ndarray:
    """int32[K, N] 32-bit slots -> int32[ceil(K/2), N] words of two
    ``path<<8|count`` halves (low half = even slot); paths and counts
    must be < 256."""
    path = (ell >> 16) & 0xFFFF
    cnt = ell & 0xFFFF
    if int(path.max(initial=0)) >= 256 or int(cnt.max(initial=0)) >= 256:
        raise ValueError("pack16 needs path ids and counts below 256")
    h = (path.astype(np.int64) << 8) | cnt.astype(np.int64)
    if h.shape[0] % 2:
        h = np.concatenate([h, np.zeros((1, h.shape[1]), h.dtype)])
    pair = (h[1::2] << 16) | h[0::2]
    return (pair & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def unpair_ell16(paired: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pair_ell16` up to slot order: int32[Kw, N] ->
    int32[2*Kw, N] 32-bit slots (even halves first)."""

    def expand(h):
        return (((h >> 8) & 0xFF) << COUNT_BITS) | (h & 0xFF)

    lo = paired & 0xFFFF
    hi = (paired >> 16) & 0xFFFF
    return torch.cat([expand(lo), expand(hi)], dim=0)


def pack_ell_tall(ell: np.ndarray) -> np.ndarray:
    """(K, N) slots -> (G*K*SUB, TALL_W), zero-padding N to a multiple
    of SUB*TALL_W: tall[(g*K + k)*SUB + r, c] =
    ell[k, g*SUB*TALL_W + r*TALL_W + c]."""
    k, n = ell.shape
    tile = SUB * TALL_W
    n_pad = -(-n // tile) * tile
    if n_pad != n:
        ell = np.concatenate(
            [ell, np.zeros((k, n_pad - n), ell.dtype)], axis=1
        )
    g = n_pad // tile
    return (
        ell.reshape(k, g, SUB, TALL_W)
        .transpose(1, 0, 2, 3)
        .reshape(g * k * SUB, TALL_W)
        .copy()
    )


def unfold_ell_tall(tall: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_ell_tall`: (G*K*SUB, TALL_W) -> (K, N_pad)."""
    g = tall.shape[0] // (k * SUB)
    return (
        tall.reshape(g, k, SUB, TALL_W)
        .permute(1, 0, 2, 3)
        .reshape(k, g * SUB * TALL_W)
    )


def pack_mask_words(mask: torch.Tensor, n_words: int) -> torch.Tensor:
    """0/1 path masks (paths on the last axis) -> int32[..., n_words] bit
    words (path p -> bit p%32 of word p//32), on the mask's device."""
    lead = mask.shape[:-1]
    m = torch.zeros((*lead, n_words * 32), dtype=torch.int64,
                    device=mask.device)
    m[..., : mask.shape[-1]] = mask.to(torch.int64)
    shifted = m.reshape(*lead, n_words, 32) << torch.arange(
        32, dtype=torch.int64, device=mask.device
    )
    words = shifted.sum(dim=-1)
    # Bit 31 set: wrap into int32's range (the kernel reads raw bits).
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_mask_words_batch(masks: torch.Tensor) -> torch.Tensor:
    """int32[Q, ceil(P/32)] bit words of a (Q, P) batch: the plain twin
    of the packing launch ahead of the batched kernels."""
    return pack_mask_words(masks, -(-masks.shape[1] // 32))


def check_ell_sub(ell_sub: int) -> None:
    """Refuse an index packed under another SUB (POLLEN_ELL_SUB): its
    tall tiers would be read in a silently wrong layout."""
    if ell_sub and ell_sub != SUB:
        raise ValueError(
            f"graph ELL index was packed with SUB={ell_sub} but this "
            f"process runs with SUB={SUB} (POLLEN_ELL_SUB); re-ingest "
            "the graph or match the env var"
        )


# --- plain versions -----------------------------------------------------


def masked_ell_depth_plain(
    flat: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth, uniq) int32[N] over flat int32[K, N] 32-bit slots, with a
    plain mask gather (twin of the reference's masked_ell_depth_xla)."""
    pid = ((flat >> COUNT_BITS) & 0xFFFF).long()
    cnt = flat & COUNT_MAX
    m = torch.zeros(1 << 16, dtype=torch.int32, device=flat.device)
    m[: mask.shape[0]] = mask.to(torch.int32)
    bit = m[pid]
    depth = (bit * cnt).sum(dim=0, dtype=torch.int32)
    uniq = (bit * (flat != 0).to(torch.int32)).sum(dim=0, dtype=torch.int32)
    return depth, uniq


def masked_ell_depth_tall_plain(
    tall: torch.Tensor, mask: torch.Tensor, k: int, pack16: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`masked_ell_depth_tall`: unfold (and
    un-pair) the tier, then the plain slot reduction."""
    flat = unfold_ell_tall(tall, k)
    if pack16:
        flat = unpair_ell16(flat)
    return masked_ell_depth_plain(flat, mask)


def masked_ell_splitn_depth_plain(tiers, heavy, mask, ks, pack16=False):
    """Plain version of :func:`masked_ell_splitn_depth`, class by class."""
    from .crossmat import masked_cross_depth_plain, pad_mask

    outs = []
    for t, k in zip(tiers, ks):
        outs += list(masked_ell_depth_tall_plain(t, mask, k, pack16))
    if heavy.numel():
        mp = pad_mask(mask, heavy.shape[0] * 2)
        outs += list(masked_cross_depth_plain(heavy, mp, nibble=True))
    return tuple(outs)


def masked_ell_splitn_depth_batch_plain(
    tiers, heavy, masks, ks, pack16=False
):
    """Plain version of :func:`masked_ell_splitn_depth_batch`: each tier
    unfolded once, then the single-query slot reduction per mask (no
    (Q, K, N) gather); the heavy block by the batched plain product."""
    from .crossmat import batched_cross_depth_plain, pad_mask

    outs = []
    for t, k in zip(tiers, ks):
        flat = unfold_ell_tall(t, k)
        if pack16:
            flat = unpair_ell16(flat)
        per_query = [masked_ell_depth_plain(flat, m) for m in masks]
        outs += [torch.stack([d for d, _ in per_query]),
                 torch.stack([u for _, u in per_query])]
    if heavy.numel():
        mp = pad_mask(masks, heavy.shape[0] * 2)
        outs += list(batched_cross_depth_plain(heavy, mp, nibble=True))
    else:
        outs += [None, None]
    return tuple(outs)


# --- kernel wrappers ----------------------------------------------------


def _check_splitn(tiers, heavy, ks):
    """Refuse a split index the fused kernels do not read (they load
    four columns of a tier as one 16-byte word, so a tier must start on
    a 16-byte boundary); returns the tiers' row groups, whether the heavy
    class is present, the device."""
    if not 1 <= len(tiers) <= 3 or len(tiers) != len(ks):
        raise ValueError(f"need 1-3 tiers with one k each, got {len(ks)}")
    gs = [_check_tall(t, k) for t, k in zip(tiers, ks)]
    if any(t.data_ptr() % 16 for t in tiers):
        raise ValueError("tier slots must start on a 16-byte boundary")
    has_heavy = heavy.numel() > 0
    if has_heavy:
        from .crossmat import check_cross

        check_cross(heavy, nibble=True)
    device = tiers[0].device
    if any(t.device != device for t in tiers) or (
        has_heavy and heavy.device != device
    ):
        raise ValueError("tiers and heavy block must share one device")
    return gs, has_heavy, device


def _check_tall(tall: torch.Tensor, k: int) -> int:
    if tall.dtype != torch.int32 or tall.dim() != 2:
        raise TypeError(f"tall slots must be 2-D int32, got {tall.dtype}")
    if tall.shape[1] != TALL_W or k <= 0 or tall.shape[0] % (k * SUB):
        raise ValueError(
            f"tall slots {tuple(tall.shape)} do not fit k={k}, SUB={SUB}"
        )
    if not tall.is_contiguous():
        raise ValueError("tall slots must be contiguous")
    return tall.shape[0] // (k * SUB)


def kernel_masks(masks: torch.Tensor, device) -> tuple:
    """The ``(masks, elem_bytes, n_paths, n_words)`` mask arguments of a
    kernel entry point for (Q, P) masks: the raw 0/1 masks (1 byte or
    int32 per path) are packed into Q rows of bit words on the card,
    ahead of the kernel (one grid row per mask: Q <= 65535)."""
    if masks.device != device:
        raise ValueError(f"mask on {masks.device}, index on {device}")
    if masks.dim() != 2 or not 1 <= masks.shape[0] <= 65535:
        raise ValueError(
            f"masks must be (Q, P) with 1 <= Q <= 65535, got "
            f"{tuple(masks.shape)}"
        )
    if masks.dtype not in (torch.bool, torch.uint8, torch.int8, torch.int32):
        masks = masks.to(torch.int32)
    masks = masks.contiguous()
    n_words = max(-(-masks.shape[1] // 32), 1)
    return masks, masks.element_size(), masks.shape[1], n_words


def kernel_mask(mask: torch.Tensor, device) -> tuple:
    """:func:`kernel_masks` for one 1-D mask."""
    if mask.dim() != 1:
        raise ValueError(f"mask must be 1-D, got shape {tuple(mask.shape)}")
    masks, elem, n_paths, n_words = kernel_masks(mask[None], device)
    return masks[0], elem, n_paths, n_words


# Mask words a block of the batched split kernel builds itself (4096
# paths: csrc/depth_batch.cu BLOCK_BITS_WORDS); past them the masks are
# packed into scratch by one launch ahead.
BATCH_BLOCK_WORDS = 128
BATCH_QCHUNK = 32  # queries a block of the batched kernels serves


def batch_scratch_words(q: int, n_paths: int) -> int:
    """Int32 scratch of :func:`masked_ell_splitn_depth_batch` for ``q``
    masks of ``n_paths``: none while a block builds its own mask bits,
    else each 32-query chunk's path-major bits (one word a path, bit j
    for query j) and each query's bit words (32 paths a word)."""
    n_words = max(-(-n_paths // 32), 1)
    if n_words <= BATCH_BLOCK_WORDS:
        return 0
    return -(-q // BATCH_QCHUNK) * n_words * 32 + q * n_words


def alloc_outputs(sizes, n_words: int, device):
    """One int32 allocation split into outputs of ``sizes`` plus the
    kernel's mask-word scratch (last)."""
    buf = torch.empty(sum(sizes) + n_words, dtype=torch.int32, device=device)
    return buf.split([*sizes, n_words])


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def masked_ell_depth(
    ell: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth, uniq) int32[N_pad] over the flat int32[K, N_pad] 32-bit
    slots of :func:`build_ell` (N_pad a multiple of 128); ``mask`` is
    0/1 per path, paths past its end read 0.
    CUDA: csrc/depth.cu pollen_ell_flat."""
    if ell.dtype != torch.int32 or ell.dim() != 2:
        raise TypeError(f"flat slots must be 2-D int32, got {ell.dtype}")
    k, n_pad = ell.shape
    if n_pad % LANES or not ell.is_contiguous():
        raise ValueError(
            f"flat slots {tuple(ell.shape)} must be contiguous with a "
            f"multiple of {LANES} columns"
        )
    if ell.device.type == "cpu":
        return masked_ell_depth_plain(ell, mask)
    if ell.device.type != "cuda":
        raise ValueError(f"no kernel for device {ell.device}")
    mask, elem, n_paths, n_words = kernel_mask(mask, ell.device)
    depth, uniq, words = alloc_outputs([n_pad, n_pad], n_words, ell.device)
    _build.check(
        "pollen_ell_flat",
        _build.load().pollen_ell_flat(
            ell.data_ptr(), k, n_pad, mask.data_ptr(), elem, n_paths,
            words.data_ptr(), n_words, depth.data_ptr(), uniq.data_ptr(),
            _stream(ell.device),
        ),
    )
    launches["ell_flat"] += 1
    return depth, uniq


def masked_ell_depth_tall(
    tall: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    pack16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth, uniq) int32[G*SUB*TALL_W] in natural column order for one
    tall tier; ``k`` counts STORED words (two slots each under pack16).
    CUDA: csrc/depth.cu pollen_ell_tier."""
    g = _check_tall(tall, k)
    if tall.device.type == "cpu":
        return masked_ell_depth_tall_plain(tall, mask, k, pack16)
    if tall.device.type != "cuda":
        raise ValueError(f"no kernel for device {tall.device}")
    mask, elem, n_paths, n_words = kernel_mask(mask, tall.device)
    n = g * SUB * TALL_W
    depth, uniq, words = alloc_outputs([n, n], n_words, tall.device)
    lib = _build.load()
    _build.check(
        "pollen_ell_tier",
        lib.pollen_ell_tier(
            tall.data_ptr(), k, g, SUB, int(pack16), mask.data_ptr(), elem,
            n_paths, words.data_ptr(), n_words, depth.data_ptr(),
            uniq.data_ptr(), _stream(tall.device),
        ),
    )
    launches["ell_tier"] += 1
    return depth, uniq


def masked_ell_splitn_depth(
    tiers: Sequence[torch.Tensor],
    heavy: torch.Tensor,
    mask: torch.Tensor,
    ks: Sequence[int],
    pack16: bool = False,
):
    """The fused split query: up to three tall tiers plus the nibble
    heavy block (``heavy.numel() == 0`` when absent) in one launch, which
    reads the raw mask itself.
    Returns ``(d_i, u_i)`` per tier, then ``(dh, uh)`` when the heavy
    class is present, each int32 in natural column order.
    CUDA: csrc/depth.cu pollen_ell_splitn."""
    gs, has_heavy, device = _check_splitn(tiers, heavy, ks)
    if device.type == "cpu":
        return masked_ell_splitn_depth_plain(tiers, heavy, mask, ks, pack16)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    mask, elem, n_paths, _ = kernel_mask(mask, device)
    sizes = [n for g in gs for n in (g * SUB * TALL_W,) * 2]
    if has_heavy:
        sizes += [heavy.shape[1]] * 2
    *outs, _ = alloc_outputs(sizes, 0, device)
    args = []
    for i, (t, k, g) in enumerate(zip(tiers, ks, gs)):
        d, u = outs[2 * i], outs[2 * i + 1]
        args += [t.data_ptr(), k, g, d.data_ptr(), u.data_ptr()]
    args += [None, 0, 0, None, None] * (3 - len(tiers))
    if has_heavy:
        h_rows, nh_pad = heavy.shape
        dh, uh = outs[-2], outs[-1]
        args += [heavy.data_ptr(), h_rows, nh_pad, dh.data_ptr(), uh.data_ptr()]
    else:
        args += [None, 0, 0, None, None]
    lib = _build.load()
    _build.check(
        "pollen_ell_splitn",
        lib.pollen_ell_splitn(
            len(tiers), *args, SUB, int(pack16), mask.data_ptr(), elem,
            n_paths, _stream(device),
        ),
    )
    launches["ell_splitn"] += 1
    return tuple(outs)


def masked_ell_splitn_depth_batch(
    tiers: Sequence[torch.Tensor],
    heavy: torch.Tensor,
    masks: torch.Tensor,
    ks: Sequence[int],
    pack16: bool = False,
):
    """The batched split query: (Q, P) masks over up to three tall tiers
    plus the nibble heavy block in one launch, whatever the tier count
    (the reference splits three-tier batches into one call per tier
    only for Mosaic's VMEM ceiling); past 4096 paths one packing launch
    runs ahead (:func:`batch_scratch_words`). Returns ``(d_i, u_i)`` per
    tier, then ``(dh, uh)`` (None, None when the heavy class is absent),
    each int32 (Q, columns) in natural column order.
    CUDA: csrc/depth_batch.cu pollen_ell_splitn_batch."""
    gs, has_heavy, device = _check_splitn(tiers, heavy, ks)
    if masks.dim() != 2 or masks.shape[0] == 0:
        raise ValueError(f"need (Q >= 1, P) masks, got {tuple(masks.shape)}")
    if device.type == "cpu":
        return masked_ell_splitn_depth_batch_plain(
            tiers, heavy, masks, ks, pack16
        )
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    masks, elem, n_paths, _ = kernel_masks(masks, device)
    q = masks.shape[0]
    cols = [c for g in gs for c in (g * SUB * TALL_W,) * 2]
    if has_heavy:
        cols += [heavy.shape[1]] * 2
    n_scratch = batch_scratch_words(q, n_paths)
    *outs, scratch = alloc_outputs([q * c for c in cols], n_scratch, device)
    args = []
    for i, (t, k, g) in enumerate(zip(tiers, ks, gs)):
        d, u = outs[2 * i], outs[2 * i + 1]
        args += [t.data_ptr(), k, g, d.data_ptr(), u.data_ptr()]
    args += [None, 0, 0, None, None] * (3 - len(tiers))
    if has_heavy:
        h_rows, nh_pad = heavy.shape
        dh, uh = outs[-2], outs[-1]
        args += [heavy.data_ptr(), h_rows, nh_pad, dh.data_ptr(), uh.data_ptr()]
    else:
        args += [None, 0, 0, None, None]
    lib = _build.load()
    _build.check(
        "pollen_ell_splitn_batch",
        lib.pollen_ell_splitn_batch(
            len(tiers), *args, SUB, int(pack16), masks.data_ptr(), elem,
            n_paths, q, scratch.data_ptr(), n_scratch, _stream(device),
        ),
    )
    launches["ell_splitn_batch"] += 1
    outs = [o.view(q, c) for o, c in zip(outs, cols)]
    return tuple(outs) if has_heavy else (*outs, None, None)


# --- the reference's fixed-arity forms of the split queries -------------


def masked_ell_split_depth(ell_tall, heavy, mask, k: int):
    """One tier plus the heavy block: ``(d, u, dh, uh)`` (K1)."""
    return masked_ell_splitn_depth([ell_tall], heavy, mask, [k])


def masked_ell_split3_depth(ell_tall, ell2_tall, heavy, mask, k: int, k2: int):
    """Two tiers plus the heavy block: ``(d1, u1, d2, u2, dh, uh)`` (K1)."""
    return masked_ell_splitn_depth([ell_tall, ell2_tall], heavy, mask, [k, k2])


def masked_ell_split3_depth_batch(
    ell_tall, ell2_tall, heavy, masks, k: int, k2: int = 0
):
    """Batched one or two tiers plus the heavy block (K4): ``(d1, u1,
    d2, u2, dh, uh)``, each (Q, columns); absent classes are None."""
    if ell2_tall.numel() and k2:
        return masked_ell_splitn_depth_batch(
            [ell_tall, ell2_tall], heavy, masks, [k, k2]
        )
    d1, u1, dh, uh = masked_ell_splitn_depth_batch([ell_tall], heavy, masks, [k])
    return d1, u1, None, None, dh, uh
