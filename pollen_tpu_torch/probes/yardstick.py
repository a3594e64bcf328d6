"""The one-call yardstick of the ELL family's kernels (K1, K3, K4, K9):
one ``torch.sparse.mm`` of a CSR float32 matrix by the float32 masks.

The matrix has two rows for each output column of the kernel: row c
holds the count of every cell the kernel reads in column c (its tier
slots, or the heavy block's nibbles) at that cell's path, and row
cols + c holds a 1 at the same places (the cell's nonzero indicator).
Times the (P, Q) masks, its first cols rows are each query's depth and
the rest its uniq, exact while every sum stays below 2^24. Cells of
paths past the mask are left out (they count 0). The matrix is built
ahead of time and is not part of a timed call; nothing in the port
calls it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..kernels import crossmat as cm
from ..kernels import ellscan as ell


def _slot_cells(flat: torch.Tensor):
    """(column, path, count) of the nonzero 32-bit ``path << 16 | count``
    slots of flat (K, N) slots."""
    k, col = torch.nonzero(flat, as_tuple=True)
    v = flat[k, col].long() & 0xFFFFFFFF
    return col, v >> ell.COUNT_BITS, v & ell.COUNT_MAX


def _heavy_cells(heavy: torch.Tensor):
    """(column, path, count) of the nonzero nibbles of a (P/2, N) nibble
    block: byte row r holds path 2r low, path 2r + 1 high."""
    a = cm.unpack_cross(heavy)  # rows [even paths | odd paths]
    row, col = torch.nonzero(a, as_tuple=True)
    half = heavy.shape[0]
    path = torch.where(row < half, 2 * row, 2 * (row - half) + 1)
    return col, path, a[row, col].long()


def ell_csr(
    n_paths: int,
    tiers: Sequence[torch.Tensor] = (),
    ks: Sequence[int] = (),
    pack16: bool = False,
    heavy: torch.Tensor | None = None,
    flat: torch.Tensor | None = None,
):
    """``(csr, cols)``: the yardstick's (2 cols, n_paths) float32 CSR
    matrix over the tall tiers (``ks`` stored words each), then the
    heavy block, then flat (K, N) 32-bit slots, in the kernels' output
    column order; ``cols`` is the output columns they span."""
    parts, cols = [], 0
    for tall, k in zip(tiers, ks):
        slots = ell.unfold_ell_tall(tall, k)
        if pack16:
            slots = ell.unpair_ell16(slots)
        parts.append((cols, _slot_cells(slots)))
        cols += slots.shape[1]
    for cells, block in ((_heavy_cells, heavy), (_slot_cells, flat)):
        if block is not None and block.numel():
            parts.append((cols, cells(block)))
            cols += block.shape[1]
    if not parts:
        raise ValueError("the yardstick needs a tier, a heavy block or slots")
    col = torch.cat([c + off for off, (c, _, _) in parts])
    path = torch.cat([p for _, (_, p, _) in parts])
    count = torch.cat([n for _, (_, _, n) in parts])
    keep = path < n_paths
    col, path, count = col[keep], path[keep], count[keep]
    index = torch.stack([torch.cat([col, col + cols]), torch.cat([path, path])])
    values = torch.cat([count, torch.ones_like(count)]).float()
    coo = torch.sparse_coo_tensor(index, values, (2 * cols, n_paths),
                                  check_invariants=True)
    return coo.coalesce().to_sparse_csr(), cols


def ell_yardstick(csr: torch.Tensor, masks_t: torch.Tensor) -> torch.Tensor:
    """The timed call: the (2 cols, Q) float32 product of ``csr`` by the
    (P, Q) float32 masks ``masks_t`` (made ahead of time)."""
    return torch.sparse.mm(csr, masks_t)


def masks_for(masks: torch.Tensor) -> torch.Tensor:
    """(Q, P) or (P,) 0/1 masks -> the (P, Q) float32 operand."""
    m = masks if masks.dim() == 2 else masks[None]
    return m.to(torch.float32).t().contiguous()


def depth_uniq(product: torch.Tensor, cols: int):
    """The product's (depth, uniq) as int32 (Q, cols)."""
    y = product.t().to(torch.int32)
    return y[:, :cols], y[:, cols:]
