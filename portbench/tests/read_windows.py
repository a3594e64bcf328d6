"""A graph shape for the tests alone, ``read_windows``: reads as
contiguous windows of a bubble chain's haplotype walks, each read a
path, its group the haplotype it was read from.

It stands in for a reads shape that a later configuration adds as its
own file under ``portbench/shapes/``: the harness finds it by name and
takes the path count from its arena, not from the configuration. The
configuration is a bubble chain's, plus ``read_steps`` (steps a read)
and ``reads_per_haplotype``; its ``paths`` stays the haplotype count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import generate, registry

CHAIN = registry.shape("bubble_chain")


def sizes(cfg: dict) -> tuple:
    segments, _ = CHAIN.sizes(cfg)
    return segments, cfg["paths"] * cfg["reads_per_haplotype"] * cfg["read_steps"]


def draw(cfg: dict, seed: int, device):
    """(arena, groups): ``reads_per_haplotype`` windows of ``read_steps``
    steps of each haplotype walk, at starts drawn from the seed (stream
    7), in haplotype order; each read's group is its haplotype."""
    chain, _ = CHAIN.draw(cfg, seed, device)
    per, length = cfg["reads_per_haplotype"], cfg["read_steps"]
    bounds = chain.path_steps.astype(np.int64)
    room = bounds[:, 1] - bounds[:, 0] - length + 1
    u = torch.rand((len(bounds), per), generator=generate.generator(seed, device, 7),
                   device=device, dtype=torch.float64).cpu().numpy()
    starts = bounds[:, :1] + np.floor(u * room[:, None]).astype(np.int64)
    steps = chain.steps[(starts.reshape(-1, 1) + np.arange(length)).reshape(-1)]
    p = starts.size
    ends = np.arange(1, p + 1, dtype=np.uint32) * length
    names = [f"r{i}".encode() for i in range(p)]
    name_ends = np.cumsum([len(n) for n in names], dtype=np.uint32)
    name_len = np.array([len(n) for n in names], np.uint32)
    arena = dataclasses.replace(
        chain,
        path_name=np.stack([name_ends - name_len, name_ends], axis=1),
        path_steps=np.stack([ends - length, ends], axis=1),
        path_overlaps=np.zeros((p, 2), np.uint32),
        steps=steps,
        name_data=np.frombuffer(b"".join(names), np.uint8).copy(),
    )
    return arena, np.repeat(np.arange(len(bounds)), per)
