"""The subset kind ``uniform``: each mask a uniform subset of the paths.

``mask_pool`` draws a pool of masks at set-up: each a subset of the
paths, its size from a fixed multiset spread evenly over [1, P] and in
an order drawn from the seed, its paths uniform, held as packed bits on
the host. ``MaskStream`` hands out request ``i`` as pool mask
``i mod K`` rotated by ``i div K`` paths, so that a window of any length
sends no mask twice while the pool stays small. It builds each request
on the host, in the window, from a P-bit row (``np.unpackbits``, and
``np.roll`` past the pool): its cost grows with P (``requests_s``).

The paths' groups are not read. The window's pool is ``generate``'s
stream 1, the warm-up's stream 2.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.generate import generator

# Masks drawn per call (bounds the keys on the device at 256 MiB for 2^17
# paths).
MASK_ROWS = 256


def streams(traffic: dict, n_paths: int, groups, seed: int, device):
    """(the window's stream, the warm-up's): ``traffic["pool"]`` masks,
    and ``warmup_calls`` x ``masks_per_call`` masks the window never
    sends."""
    warm = traffic["warmup_calls"] * traffic["masks_per_call"]
    return (MaskStream(mask_pool(traffic["pool"], n_paths, seed, device, 1), n_paths),
            MaskStream(mask_pool(warm, n_paths, seed, device, 2), n_paths))


def mask_pool(n_masks: int, n_paths: int, seed: int, device,
              stream: int = 1) -> np.ndarray:
    """``n_masks`` subset masks over ``n_paths`` paths as packed bits,
    uint8[n_masks, ceil(P / 8)] on the host (``np.packbits`` order):
    mask ``j`` holds the ``k_j`` paths with the smallest of P uniform
    keys. The sizes ``k`` are a fixed multiset spread evenly over [1, P]
    (``pool_sizes``) in an order drawn from the seed, so that every seed
    asks for the same work. Drawn on ``device``, ``MASK_ROWS`` masks a
    call."""
    device = torch.device(device)
    gen = generator(seed, device, stream)
    order = torch.randperm(n_masks, generator=gen, device=device)
    sizes = torch.as_tensor(pool_sizes(n_masks, n_paths), device=device)[order]
    width = -(-n_paths // 8) * 8
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=device)
    out = []
    for lo in range(0, n_masks, MASK_ROWS):
        k = sizes[lo : lo + MASK_ROWS]
        keys = torch.rand((k.numel(), n_paths), generator=gen, device=device,
                          dtype=torch.float64)
        kth = keys.sort(dim=1).values.gather(1, (k - 1)[:, None])
        bits = torch.zeros((k.numel(), width), dtype=torch.int32, device=device)
        bits[:, :n_paths] = (keys <= kth).to(torch.int32)
        packed = (bits.view(k.numel(), -1, 8) * weights).sum(dim=2)
        out.append(packed.to(torch.uint8).cpu().numpy())
    return np.concatenate(out)


def pool_sizes(n_masks: int, n_paths: int) -> np.ndarray:
    """The sizes of a pool's masks, in ascending order: ``n_masks``
    evenly spaced quantiles of the uniform distribution on [1, P]."""
    return 1 + (np.arange(n_masks, dtype=np.int64) * n_paths) // n_masks


class MaskStream:
    """Request ``i``'s masks: pool row ``i mod K`` rotated by ``i div K``
    paths (a rotation of a uniform subset is a uniform subset)."""

    def __init__(self, pool: np.ndarray, n_paths: int):
        self.pool, self.n_paths = pool, n_paths

    def mask(self, i: int) -> np.ndarray:
        k = self.pool.shape[0]
        row = np.unpackbits(self.pool[i % k], count=self.n_paths).view(bool)
        shift = i // k
        return np.roll(row, shift % self.n_paths) if shift else row

    def masks(self, first: int, count: int) -> np.ndarray:
        """(count, P) bool: the masks of requests first .. first+count-1."""
        return np.stack([self.mask(first + j) for j in range(count)])
