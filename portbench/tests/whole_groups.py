"""A subset kind for the tests alone, ``whole_groups``: each mask
selects whole groups of paths (a read's sample, say), the groups a
uniform subset of all groups, drawn as the ``uniform`` kind draws a
subset of paths.

It stands in for a kind that a later traffic mix adds as its own file
under ``portbench/subsets/``. A request is a gather of a G-bit group
selection over the P paths, so building it costs O(P) with no roll of
a P-bit row.
"""

from __future__ import annotations

import numpy as np

from portbench import registry

UNIFORM = registry.subsets("uniform")


class GroupStream:
    """Request ``i``: pool row ``i mod K`` of group selections, rotated
    by ``i div K`` groups, over each path's group."""

    def __init__(self, pool: np.ndarray, groups: np.ndarray):
        self.pool, self.groups = pool, groups

    def mask(self, i: int) -> np.ndarray:
        k = self.pool.shape[0]
        return np.roll(self.pool[i % k], i // k)[self.groups]

    def masks(self, first: int, count: int) -> np.ndarray:
        return np.stack([self.mask(first + j) for j in range(count)])


def streams(traffic: dict, n_paths: int, groups, seed: int, device):
    groups = np.asarray(groups)
    if groups.shape != (n_paths,):
        raise ValueError(f"{groups.shape[0]} groups for {n_paths} paths")
    g = int(groups.max()) + 1

    def pool(n, stream):
        packed = UNIFORM.mask_pool(n, g, seed, device, stream)
        return np.unpackbits(packed, axis=1, count=g).view(bool)

    warm = traffic["warmup_calls"] * traffic["masks_per_call"]
    return GroupStream(pool(traffic["pool"], 1), groups), GroupStream(pool(warm, 2), groups)
