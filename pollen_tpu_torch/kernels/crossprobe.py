"""The crossing-matrix probe ladder: four variants of the masked nibble
GEMV that split the dense query's time (``crossmat.masked_cross_depth``)
into its stages on the card.

    raw  depth = sum_r mask[2r] * byte[r, n], the raw byte with no
         unpack, returned as both outputs (the floor: one load and one
         multiply-add per byte)
    vd   the exact masked depth, returned as both outputs (no indicator)
    v1   exact (depth, uniq), the same function as the dense query
    v2   v1, but a tile of :data:`TILE` columns whose flag is 0 returns
         depth as uniq: exact when the flags come from :func:`tile_flags`

Each takes the uint8 (P/2, N) nibble matrix and the raw 0/1 mask in path
order (padded or cut to P), and folds it as the dense query does. Ports
of the TPU probes ``probes/crossmat_floor.py`` (raw, vd) and
``probes/crossmat_variants.py`` (v1, v2); the CUDA kernel is the dense
query's own (``csrc/probes.cu`` pollen_cross_probe runs
``csrc/cross.cuh`` cross_kernel), one launch a call. A wrapper runs the
plain version only for tensors on the CPU; on a CUDA tensor it launches
its kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .crossmat import LANES, check_cross, masked_cross_depth_plain, pad_mask

MODES = ("raw", "vd", "v1", "v2")
# Columns of one v2 flag: a warp's span of the dense query's tile (32
# lanes x 16 columns), so that the kernel's branch on it is warp-uniform
# whatever the tile's row groups. When the columns are not a multiple of
# it, the last tile is narrower.
TILE = 512

# Launch counts of the CUDA kernel, per mode (plain calls do not count).
launches = {f"cross_probe_{m}": 0 for m in MODES}


def n_tiles(n_pad: int, width: int = TILE) -> int:
    """Tiles of ``width`` columns over ``n_pad``, the last one ragged."""
    return -(-n_pad // width)


def tile_flags(cross: torch.Tensor, width: int = TILE) -> torch.Tensor:
    """int32[ceil(N / width)], 1 where a tile of ``width`` columns of the
    nibble matrix (the last tile: what is left) holds any count >= 2, on
    the matrix's device."""
    n_pad = cross.shape[1]
    if width <= 0 or width % LANES:
        raise ValueError(
            f"tiles of {width} columns: a tile is a positive multiple of "
            f"{LANES} columns, as the matrix is"
        )
    big = (((cross & 15) >= 2) | ((cross >> 4) >= 2)).any(dim=0)
    tiles = n_tiles(n_pad, width)
    big = torch.nn.functional.pad(big, (0, tiles * width - n_pad))
    return big.reshape(tiles, width).any(dim=1).to(torch.int32)


def cross_probe_plain(
    cross: torch.Tensor,
    mask: torch.Tensor,
    mode: str,
    flags: Optional[torch.Tensor] = None,
    width: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the probe ``mode``; v2 reads one flag per tile
    of ``width`` columns (the last tile ragged)."""
    check_cross(cross, nibble=True)
    rows, n_pad = cross.shape
    mp = pad_mask(mask, 2 * rows)
    if mode == "raw":
        depth = (cross.to(torch.int32) * mp[0::2, None]).sum(0, dtype=torch.int32)
        return depth, depth.clone()
    depth, uniq = masked_cross_depth_plain(cross, mp, nibble=True)
    if mode == "vd":
        return depth, depth.clone()
    if mode == "v1":
        return depth, uniq
    if mode != "v2":
        raise ValueError(f"unknown probe mode {mode!r}, want one of {MODES}")
    tiles = n_tiles(n_pad, width)
    if flags is None or flags.dim() != 1 or flags.shape[0] != tiles:
        raise ValueError(f"v2 needs one flag per {width} columns ({tiles})")
    keep = flags.repeat_interleave(width)[:n_pad] != 0
    return depth, torch.where(keep, uniq, depth)


def _probe(mode, cross, mask, flags=None):
    check_cross(cross, nibble=True)
    rows, n_pad = cross.shape
    tiles = n_tiles(n_pad)
    if mode == "v2" and (
        flags is None
        or flags.dim() != 1
        or flags.shape[0] != tiles
        or flags.dtype != torch.int32
        or flags.device != cross.device
    ):
        raise ValueError(
            f"v2 needs int32 flags on {cross.device}, one per {TILE} "
            f"columns ({tiles})"
        )
    if cross.device.type == "cpu":
        return cross_probe_plain(cross, mask, mode, flags)
    if cross.device.type != "cuda":
        raise ValueError(f"no kernel for device {cross.device}")
    from .ellscan import alloc_outputs, kernel_mask

    mask, elem, n_paths, _ = kernel_mask(mask, cross.device)
    depth, uniq, _ = alloc_outputs([n_pad, n_pad], 0, cross.device)
    flags = flags.contiguous() if flags is not None else None
    _build.check(
        "pollen_cross_probe",
        _build.load().pollen_cross_probe(
            MODES.index(mode), cross.data_ptr(), rows, n_pad, mask.data_ptr(),
            elem, n_paths, None if flags is None else flags.data_ptr(),
            depth.data_ptr(), uniq.data_ptr(),
            torch.cuda.current_stream(cross.device).cuda_stream,
        ),
    )
    launches[f"cross_probe_{mode}"] += 1
    return depth, uniq


def cross_probe_raw(cross, mask):
    """K10 raw: the byte floor (see the module notes)."""
    return _probe("raw", cross, mask)


def cross_probe_vd(cross, mask):
    """K10 vd: exact depth, stored as both outputs."""
    return _probe("vd", cross, mask)


def cross_probe_v1(cross, mask):
    """K11: exact (depth, uniq)."""
    return _probe("v1", cross, mask)


def cross_probe_v2(cross, mask, flags):
    """K12: v1 with a per-tile uniq skip; ``flags`` int32, one per
    :data:`TILE` columns (:func:`n_tiles`)."""
    return _probe("v2", cross, mask, flags)
