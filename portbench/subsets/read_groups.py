"""The subset kind ``read_groups``: each mask selects whole read groups
(a sample's reads on one flow cell, say), as ``odgi depth -s`` over one
sample's or one flow cell's reads asks.

The shape gives each path's group, ascending, so each of the G groups
is a contiguous range of paths. At set-up each stream draws a pool of
group selections: the count of groups a selection takes is a fixed
multiset spread evenly over [1, G], in an order drawn from the seed, and
the groups it takes are uniform among the G (the ``count`` with the
smallest of G uniform keys). Request ``i`` is pool row ``i mod K``
rotated by ``i div K`` groups, so every seed asks for the same work. A
request is built on the host, in the window, as ``np.repeat`` of its
G-bit selection over the groups' sizes: a fill of P bytes a mask, with
no gather over the paths.

With 12 groups there are 4,095 selections, so a window sends each many
times, and the warm-up's selections are among them; the program keeps
nothing of one call for the next, so a repeated mask costs what a new
one does. The window's pool is ``generate``'s stream 5, the warm-up's
stream 6, which no other draw of a run takes.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.generate import generator

WINDOW_STREAM, WARMUP_STREAM = 5, 6


def counts(n_masks: int, n_groups: int) -> np.ndarray:
    """The groups each selection of a pool takes, ascending: ``n_masks``
    evenly spaced quantiles of the uniform distribution on [1, G]."""
    return 1 + (np.arange(n_masks, dtype=np.int64) * n_groups) // n_masks


def selection_pool(n_masks: int, n_groups: int, seed: int, device,
                   stream: int) -> np.ndarray:
    """bool[n_masks, G] on the host: selection ``j`` takes the ``k_j``
    groups with the smallest of G uniform keys, the counts ``k``
    (:func:`counts`) in an order drawn from the seed."""
    device = torch.device(device)
    gen = generator(seed, device, stream)
    order = torch.randperm(n_masks, generator=gen, device=device)
    k = torch.as_tensor(counts(n_masks, n_groups), device=device)[order]
    keys = torch.rand((n_masks, n_groups), generator=gen, device=device,
                      dtype=torch.float64)
    kth = keys.sort(dim=1).values.gather(1, (k - 1)[:, None])
    return (keys <= kth).cpu().numpy()


class GroupStream:
    """Request ``i``'s masks: pool row ``i mod K`` rotated by ``i div K``
    groups, repeated over each group's paths. The G rotations of the
    pool are made once, so a request is one lookup and one repeat."""

    def __init__(self, pool: np.ndarray, sizes: np.ndarray):
        self.k, self.sizes = pool.shape[0], sizes
        self.rotated = np.stack([np.roll(pool, r, axis=1) for r in range(sizes.size)])

    def masks(self, first: int, count: int) -> np.ndarray:
        """(count, P) bool: the masks of requests first .. first+count-1."""
        i = np.arange(first, first + count)
        sel = self.rotated[(i // self.k) % self.sizes.size, i % self.k]
        return np.repeat(sel, self.sizes, axis=1)

    def mask(self, i: int) -> np.ndarray:
        return self.masks(i, 1)[0]


def streams(traffic: dict, n_paths: int, groups, seed: int, device):
    """(the window's stream, the warm-up's): ``traffic["pool"]``
    selections, and ``warmup_calls`` x ``masks_per_call``."""
    if groups is None:
        raise ValueError("read groups need a shape that gives each path's group")
    groups = np.asarray(groups)
    if groups.shape != (n_paths,) or (np.diff(groups) < 0).any():
        raise ValueError("the groups must be ascending, one a path")
    sizes = np.bincount(groups)
    g = sizes.size
    warm = traffic["warmup_calls"] * traffic["masks_per_call"]
    return (GroupStream(selection_pool(traffic["pool"], g, seed, device, WINDOW_STREAM), sizes),
            GroupStream(selection_pool(warm, g, seed, device, WARMUP_STREAM), sizes))
