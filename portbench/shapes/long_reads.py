"""The shape ``long_reads``: long reads aligned to a chromosome graph and
held as its paths, as Pollen's ``inject`` (and a GAF's alignments) keeps
them, drawn on the device from the seed.

The configuration's ``chain`` is another shape's whole configuration
(its own ``shape`` key names it): the graph the reads align to, drawn
first, from the same seed, by that shape. Its haplotype walks are the
genomes the reads were sequenced from; its own paths are not held.
``samples`` samples own ``haplotypes_per_sample`` walks each (sample
``s`` the walks ``s * H`` to ``s * H + H - 1``), each sequenced at
``coverage`` over ``genome_bp`` on ``flow_cells`` flow cells.

Read lengths (``read_steps``): each sample holds
``round(coverage * genome_bp / read_bp.mean)`` reads, their lengths in
bp the quantiles of a log-normal of mean ``read_bp.mean`` and log-scale
``read_bp.sigma``, each over the chain's mean bp a step (``genome_bp``
over a haplotype walk's mean steps), rounded, at least one step. These
are fixed multisets, so every seed gives the same path and step counts
(``sizes``).

From the seed, on the device (``generate.generator``'s stream 4, which
no other draw of a run takes): the order of each sample's read lengths,
and so which flow cell holds which (the sample's reads in that order,
split into ``flow_cells`` ranges whose counts differ by at most one),
each read's haplotype among its sample's, its start (uniform over the
windows of its length on that walk) and its strand. A reverse read walks
its window backwards, each handle's orientation flipped. Paths are
ordered by (sample, flow cell): read group ``s * flow_cells + f`` is a
contiguous range of paths, and ``draw`` returns each read's group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import generate, registry

STREAM = 4


def _chain(cfg: dict):
    return registry.shape(cfg["chain"]["shape"])


def read_steps(cfg: dict) -> np.ndarray:
    """One sample's read lengths in steps, ascending (the same multiset
    for every sample and seed)."""
    chain = cfg["chain"]
    _, chain_steps = _chain(cfg).sizes(chain)
    bp_per_step = cfg["genome_bp"] * chain["paths"] / chain_steps
    rb = cfg["read_bp"]
    n = round(cfg["coverage"] * cfg["genome_bp"] / rb["mean"])
    q = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    mu = np.log(rb["mean"]) - rb["sigma"] ** 2 / 2
    bp = torch.exp(mu + rb["sigma"] * torch.special.ndtri(q)).numpy()
    return np.maximum(np.rint(bp / bp_per_step), 1).astype(np.int64)


def sizes(cfg: dict) -> tuple:
    """(segments, steps) of the configuration's graph, for every seed;
    its path count is ``samples * len(read_steps(cfg))``."""
    segments, _ = _chain(cfg).sizes(cfg["chain"])
    return segments, int(cfg["samples"] * read_steps(cfg).sum())


def _names(p: int):
    names = [f"r{i}".encode() for i in range(p)]
    ends = np.cumsum([len(n) for n in names], dtype=np.uint32)
    lens = np.array([len(n) for n in names], np.uint32)
    return np.stack([ends - lens, ends], axis=1), np.frombuffer(b"".join(names), np.uint8).copy()


def draw(cfg: dict, seed: int, device):
    """(arena, groups): the reads of ``seed`` (see the module's
    docstring) as the paths of the chain's graph, drawn on ``device``,
    and each read's group, int64[P], ascending."""
    device = torch.device(device)
    chain, _ = _chain(cfg).draw(cfg["chain"], seed, device)
    n_s, h, f = cfg["samples"], cfg["haplotypes_per_sample"], cfg["flow_cells"]
    lens = torch.from_numpy(read_steps(cfg)).to(device)
    per = lens.numel()
    p = n_s * per
    gen = generate.generator(seed, device, STREAM)

    # The sampled haplotypes' walks, back to back on the device.
    bounds = chain.path_steps[: n_s * h].astype(np.int64)
    walk_len = torch.from_numpy(bounds[:, 1] - bounds[:, 0]).to(device)
    walks = torch.from_numpy(np.concatenate(
        [chain.steps[lo:hi] for lo, hi in bounds]).astype(np.int64)).to(device)
    walk_at = torch.cumsum(walk_len, 0) - walk_len

    length = torch.cat([lens[torch.randperm(per, generator=gen, device=device)]
                        for _ in range(n_s)])
    sample = torch.arange(p, device=device) // per
    hap = sample * h + torch.randint(0, h, (p,), generator=gen, device=device)
    if bool((length > walk_len[hap]).any()):
        raise ValueError("a read is longer than the walk it is drawn from")
    u = torch.rand(p, generator=gen, device=device, dtype=torch.float64)
    start = walk_at[hap] + torch.floor(
        u * (walk_len[hap] - length + 1).double()).long()
    reverse = torch.rand(p, generator=gen, device=device) < 0.5

    total = int(length.sum())
    ends = torch.cumsum(length, 0)
    read = torch.repeat_interleave(torch.arange(p, device=device), length,
                                   output_size=total)
    j = torch.arange(total, device=device) - (ends - length)[read]
    rev = reverse[read]
    j = torch.where(rev, length[read] - 1 - j, j)
    steps = walks[start[read] + j] ^ rev.long()
    del read, j, rev
    steps_h = steps.to(torch.int32).cpu().numpy().view(np.uint32)
    ends_h = ends.cpu().numpy().astype(np.uint32)
    del steps, walks

    within = np.arange(p) % per
    groups = (np.arange(p) // per) * f + within * f // per
    path_name, name_data = _names(p)
    arena = dataclasses.replace(
        chain,
        path_name=path_name,
        path_steps=np.stack([np.concatenate(([0], ends_h[:-1])), ends_h],
                            axis=1).astype(np.uint32),
        path_overlaps=np.zeros((p, 2), np.uint32),
        steps=steps_h,
        name_data=name_data,
    )
    return arena, groups.astype(np.int64)
