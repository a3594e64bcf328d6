"""Crossing-matrix depth: masked depth + uniq over a dense (path,
segment) count matrix.

``A[p, n]`` counts the steps of segment n on path p, stored nibble
packed (two path rows per byte, counts clipped at 15: byte row r holds
path 2r in its low nibble, path 2r+1 in its high nibble) or as int8
(clipped at 127, row = path). The masked query is a GEMV:

    depth = mask @ A          uniq = mask @ min(A, 1)

Clipped remainders live in the residual sidecar that the caller adds
(ops/depth.py). Host constants and the plain versions are a jax-free
port of pollen_tpu/kernels/crossmat.py; the CUDA kernels are
``csrc/depth.cu`` pollen_cross_depth (one mask, one launch that reads
the raw mask itself) and ``csrc/depth_batch.cu``
pollen_cross_depth_batch (Q masks at once).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

LANES = 128
SEG_BLOCK = 8192  # heavy-column padding tile of the reference's layout
CLIP = 127  # largest count stored per int8 cell
CLIP_NIBBLE = 15  # largest count stored per nibble cell
# Segment id of residual-sidecar padding columns: out of range for any
# depth vector, so the residual add masks those columns out.
RES_SENTINEL = 2**30

# Launch counts of the CUDA kernels (plain-version calls do not count).
launches = {"cross": 0, "cross_batch": 0}


def fold_mask(mask: torch.Tensor) -> torch.Tensor:
    """Reorder path-indexed vectors (the last axis) into the row order
    of :func:`unpack_cross`: even paths first, then odd paths."""
    return torch.cat([mask[..., 0::2], mask[..., 1::2]], dim=-1)


def unpack_cross(cross: torch.Tensor) -> torch.Tensor:
    """uint8 (P/2, N) nibbles -> int32 (P, N) in [0::2 | 1::2] row order
    (pair with :func:`fold_mask`)."""
    t = cross.to(torch.int32)
    return torch.cat([t & 15, t >> 4], dim=0)


def pad_mask(mask: torch.Tensor, p_pad: int) -> torch.Tensor:
    """0/1 path masks as int32 with p_pad entries on the last axis,
    zero-padded (or cut) to p_pad."""
    m = mask.to(torch.int32)[..., :p_pad]
    return torch.nn.functional.pad(m, (0, p_pad - m.shape[-1]))


def masked_cross_depth_plain(
    cross: torch.Tensor, mask: torch.Tensor, nibble: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth, uniq) int32[N_pad], exact int32 sums (twin of the
    reference's masked_cross_depth_xla); ``mask`` has P_pad entries."""
    if nibble:
        a = unpack_cross(cross)
        mask = fold_mask(mask)
    else:
        a = cross.to(torch.int32)
    m = mask.to(torch.int32)[:, None]
    depth = (a * m).sum(dim=0, dtype=torch.int32)
    uniq = (torch.clamp(a, max=1) * m).sum(dim=0, dtype=torch.int32)
    return depth, uniq


def batched_cross_depth_plain(
    cross: torch.Tensor, masks: torch.Tensor, nibble: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth, uniq) int32[Q, N_pad] for (Q, P_pad) masks (twin of the
    reference's batched_cross_depth). Exact: float64 products and sums
    of integers far below 2^53 (torch.matmul has no int32 CUDA form)."""
    if nibble:
        a = unpack_cross(cross)
        masks = fold_mask(masks)
    else:
        a = cross.to(torch.int32)
    m = masks.to(torch.float64)
    depth = m @ a.to(torch.float64)
    uniq = m @ torch.clamp(a, max=1).to(torch.float64)
    return depth.to(torch.int32), uniq.to(torch.int32)


def check_cross(cross: torch.Tensor, nibble: bool) -> None:
    """Refuse a matrix the kernels do not read."""
    want = torch.uint8 if nibble else torch.int8
    if cross.dtype != want or cross.dim() != 2:
        raise TypeError(
            f"cross matrix must be 2-D {want} (nibble={nibble}), "
            f"got {cross.dtype}"
        )
    if (
        cross.shape[1] % LANES
        or not cross.is_contiguous()
        or cross.data_ptr() % 4
    ):
        raise ValueError(
            f"cross matrix {tuple(cross.shape)} must be contiguous and "
            f"4-byte aligned, with a multiple of {LANES} columns"
        )


def masked_cross_depth(
    cross: torch.Tensor,
    mask: torch.Tensor,
    nibble: bool = False,
    uniq: bool = True,
):
    """(depth, uniq) int32[N_pad] over ``cross`` (uint8 nibble packed or
    int8), or depth alone with ``uniq=False``. ``mask`` is 0/1 per path,
    in the original path order. CUDA: csrc/depth.cu pollen_cross_depth."""
    check_cross(cross, nibble)
    rows, n_pad = cross.shape
    if cross.device.type == "cpu":
        mp = pad_mask(mask, rows * 2 if nibble else rows)
        d, u = masked_cross_depth_plain(cross, mp, nibble=nibble)
        return (d, u) if uniq else d
    if cross.device.type != "cuda":
        raise ValueError(f"no kernel for device {cross.device}")
    from .ellscan import kernel_mask

    mask, elem, n_paths, _ = kernel_mask(mask, cross.device)
    outs = torch.empty(
        (2 if uniq else 1, n_pad), dtype=torch.int32, device=cross.device
    ).unbind(0)
    lib = _build.load()
    _build.check(
        "pollen_cross_depth",
        lib.pollen_cross_depth(
            cross.data_ptr(), rows, n_pad, int(nibble), mask.data_ptr(),
            elem, n_paths, outs[0].data_ptr(),
            outs[1].data_ptr() if uniq else None,
            torch.cuda.current_stream(cross.device).cuda_stream,
        ),
    )
    launches["cross"] += 1
    return tuple(outs) if uniq else outs[0]


def batched_cross_depth(
    cross: torch.Tensor, masks: torch.Tensor, nibble: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth, uniq) int32[Q, N_pad] for Q masks at once: one read of
    ``cross`` serves every query (the serving shape). ``masks`` is
    (Q, P) 0/1 in the original path order; P is padded or cut to the
    matrix's paths. CUDA: csrc/depth_batch.cu pollen_cross_depth_batch."""
    check_cross(cross, nibble)
    rows, n_pad = cross.shape
    if masks.dim() != 2 or masks.shape[0] == 0:
        raise ValueError(f"need (Q >= 1, P) masks, got {tuple(masks.shape)}")
    if cross.device.type == "cpu":
        mp = pad_mask(masks, rows * 2 if nibble else rows)
        return batched_cross_depth_plain(cross, mp, nibble=nibble)
    if cross.device.type != "cuda":
        raise ValueError(f"no kernel for device {cross.device}")
    from .ellscan import alloc_outputs, kernel_masks

    masks, elem, n_paths, n_words = kernel_masks(masks, cross.device)
    q = masks.shape[0]
    depth, uniq, words = alloc_outputs(
        [q * n_pad] * 2, q * n_words, cross.device
    )
    lib = _build.load()
    _build.check(
        "pollen_cross_depth_batch",
        lib.pollen_cross_depth_batch(
            cross.data_ptr(), rows, n_pad, int(nibble), masks.data_ptr(),
            elem, n_paths, q, words.data_ptr(), n_words, depth.data_ptr(),
            uniq.data_ptr(),
            torch.cuda.current_stream(cross.device).cuda_stream,
        ),
    )
    launches["cross_batch"] += 1
    return depth.view(q, n_pad), uniq.view(q, n_pad)
