"""The shape ``bubble_chain``: a pangenome graph of the shape a
Minigraph-Cactus chromosome graph has, drawn on the device from the
seed.

A chain of sites along the reference, each a backbone segment that
every haplotype visits followed by a bubble, and one path per haplotype
that walks the chain in order, taking one allele of each bubble. The
bubbles (``plan``):

- ``snv``: two one-segment alleles; carriers of the alternative take
  the second;
- ``del``: a one-segment allele that carriers skip;
- ``ins``: an allele of ``L`` segments that only carriers walk;
- ``vntr``: a loop over a unit of ``U`` segments that each haplotype
  walks its own number of times (a tandem repeat's copy number).

So a haplotype visits each segment once, except inside a loop, and a
segment's depth is bounded by the haplotype count times its copies.
The carriers of a site's alternative allele follow the neutral site
frequency spectrum (a site with ``k`` of ``P`` carriers has weight
``1/k``), and the haplotypes that carry ``inversion`` walk that stretch
of the chain backwards, each step reversed.

Every count is a fixed multiset of the configuration (quantiles, paired
in a fixed order): the seed only orders the sites and chooses which
haplotypes carry what, so every seed gives the same segment and step
counts (``sizes``), and the configuration's ``paths`` is the path
count. The draws are a ``torch.Generator``'s on the run's device
(``generate.generator``'s stream 0), in a few large calls; only the
arena's arrays go to the host, where the program's ingest reads them.
The paths form no groups.
"""

from __future__ import annotations

import numpy as np
import torch

from pollen_tpu_torch.flatgfa import GraphArrays
from portbench.generate import generator

KINDS = ("snv", "del", "ins", "vntr")
SNV, DEL, INS, VNTR = range(4)
# The fixed order in which the multisets of a kind are paired (insertion
# lengths with carrier counts, repeat units with copy numbers): a
# constant, so that the pairs, and with them the counts, are the same
# for every seed.
PAIRING_SEED = 20231


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / max(n, 1)


def plan(cfg: dict) -> dict:
    """The sites of a configuration in a fixed order, before the seed
    orders them: int64 arrays ``kind``, ``unit`` (segments of the
    variable allele, or of the loop's unit), ``carriers`` (haplotypes
    with the alternative allele; 0 for a loop) and ``copies`` (a loop's
    mean copy number; 0 otherwise)."""
    s, p = cfg["sites"], cfg["paths"]
    shares = cfg["site_kinds"]
    count = {k: int(shares[k] * s) for k in KINDS[1:]}
    count["snv"] = s - sum(count.values())
    kind = np.repeat(np.arange(len(KINDS)), [count[k] for k in KINDS])
    unit = np.ones(s, np.int64)
    carriers = np.zeros(s, np.int64)
    copies = np.zeros(s, np.int64)
    # Carrier counts: quantiles of the neutral spectrum over 1..P-1.
    w = 1.0 / np.arange(1, p)
    cdf = np.cumsum(w) / w.sum()
    pair = np.random.default_rng(PAIRING_SEED)
    lo = 0
    for k in range(len(KINDS)):
        n = count[KINDS[k]]
        sl = slice(lo, lo + n)
        lo += n
        if k == VNTR:
            ulo, uhi = cfg["vntr_unit_segments"]
            clo, chi = cfg["vntr_copies"]
            unit[sl] = ulo + np.arange(n) % (uhi - ulo + 1)
            copies[sl] = pair.permutation(clo + np.floor(
                _quantiles(n) * (chi - clo + 1)).astype(np.int64))
            continue
        carriers[sl] = np.minimum(np.searchsorted(cdf, _quantiles(n)) + 1, p - 1)
        if k == INS:
            # Insertion lengths 1 + geometric with mean ins_segments - 1.
            q = 1.0 - 1.0 / cfg["ins_segments"]
            unit[sl] = pair.permutation(
                1 + np.floor(np.log1p(-_quantiles(n)) / np.log(q)).astype(np.int64))
    return dict(kind=kind, unit=unit, carriers=carriers, copies=copies)


def _site_segments(kind, unit):
    """Segments of each site: the backbone, then both alleles of an snv,
    the allele of a deletion or insertion, or a loop's unit."""
    return 1 + (kind == SNV) + unit


def _loop_copies(rank, mean, p: int):
    """A loop's copy number for the haplotype of rank ``rank`` (0 to
    P-1) at a site of mean copy number ``mean``: spread evenly over
    [1, 2 * mean - 1], so that a site's total is the same for any order."""
    return 1 + ((2 * rank + 1) * (2 * mean - 1)) // (2 * p)


def sizes(cfg: dict) -> tuple:
    """(segments, steps) of the configuration's graph, for every seed."""
    pl = plan(cfg)
    p = cfg["paths"]
    kind, unit, k = pl["kind"], pl["unit"], pl["carriers"]
    segments = int(_site_segments(kind, unit).sum())
    emitted = np.select(
        [kind == SNV, kind == DEL, kind == INS],
        [np.full_like(k, p), p - k, k * unit], 0)
    ranks = np.arange(p)
    loops = np.flatnonzero(kind == VNTR)
    emitted[loops] = unit[loops] * np.array(
        [_loop_copies(ranks, m, p).sum() for m in pl["copies"][loops]], np.int64)
    return segments, int(p * kind.size + emitted.sum())


def draw(cfg: dict, seed: int, device):
    """(arena, groups): the configuration's graph for ``seed`` (see the
    module's docstring), drawn on ``device``, and None: its paths form
    no groups."""
    device = torch.device(device)
    p = cfg["paths"]
    gen = generator(seed, device, 0)
    pl = {k: torch.from_numpy(v).to(device) for k, v in plan(cfg).items()}
    s = pl["kind"].numel()
    order = torch.randperm(s, generator=gen, device=device)
    kind, unit = pl["kind"][order], pl["unit"][order]
    carriers, copies = pl["carriers"][order], pl["copies"][order]
    seg_count = _site_segments(kind, unit)
    backbone = torch.cumsum(seg_count, 0) - seg_count
    n_segs = int(seg_count.sum())

    # Each haplotype's rank at each site orders who carries, and who
    # walks a loop how often: (P, S), haplotype-major like the paths.
    keys = torch.rand((s, p), generator=gen, device=device, dtype=torch.float32)
    rank = keys.argsort(dim=1).argsort(dim=1).t().contiguous()
    del keys
    carry = rank < carriers
    loop = _loop_copies(rank, copies, p)
    emitted = torch.where(kind == SNV, 1,
              torch.where(kind == DEL, (~carry).long(),
              torch.where(kind == INS, carry.long() * unit, unit * loop)))
    first = backbone + 1 + ((kind == SNV) & carry).long()
    del rank, loop
    n = (1 + emitted).reshape(-1)
    del emitted
    total = int(n.sum())
    ends = torch.cumsum(n, 0)
    starts = ends - n
    idx = torch.repeat_interleave(torch.arange(n.numel(), device=device), n,
                                  output_size=total)
    pos = torch.arange(total, device=device)
    j = pos - starts[idx]
    site = idx % s
    seg = torch.where(j == 0, backbone[site],
                      first.reshape(-1)[idx] + torch.remainder(j - 1, unit[site]))
    del j, first, n

    # The inversion: its carriers walk sites [lo, hi) backwards.
    inv = cfg["inversion"]
    lo, hi = int(inv["first_site_share"] * s), int(inv["last_site_share"] * s)
    inv_hap = torch.zeros(p, dtype=torch.bool, device=device)
    inv_hap[torch.randperm(p, generator=gen, device=device)[
        : round(inv["carrier_share"] * p)]] = True
    hap = idx // s
    a = starts.view(p, s)[:, lo]
    b = starts.view(p, s)[:, hi] if hi < s else ends.view(p, s)[:, -1]
    inside = inv_hap[hap] & (site >= lo) & (site < hi)
    dest = torch.where(inside, a[hap] + b[hap] - 1 - pos, pos)
    steps = torch.empty(total, dtype=torch.int32, device=device)
    steps[dest] = ((seg << 1) | inside.long()).to(torch.int32)
    del idx, pos, site, seg, hap, inside, dest
    path_len = ends.view(p, s)[:, -1] - starts.view(p, s)[:, 0]

    lo_bp, hi_bp = cfg["segment_bp"]
    seg_lens = torch.randint(lo_bp, hi_bp + 1, (n_segs,), generator=gen,
                             device=device, dtype=torch.int64)
    steps_h = steps.cpu().numpy().view(np.uint32)
    lens_h = seg_lens.cpu().numpy().astype(np.uint32)
    bounds = np.concatenate(([0], np.cumsum(path_len.cpu().numpy()))).astype(np.uint32)
    del steps, seg_lens

    seq_bounds = np.concatenate(([0], np.cumsum(lens_h, dtype=np.uint64)))
    seq_bounds = seq_bounds.astype(np.uint32)
    name_len = np.array([len(f"p{i}") for i in range(p)], np.uint32)
    name_ends = np.cumsum(name_len, dtype=np.uint32)
    names = "".join(f"p{i}" for i in range(p)).encode()
    arena = GraphArrays(
        header=np.zeros(0, np.uint8),
        seg_name=np.arange(1, n_segs + 1, dtype=np.int64),
        seg_seq=np.stack([seq_bounds[:-1], seq_bounds[1:]], axis=1),
        seg_optional=np.zeros((n_segs, 2), np.uint32),
        path_name=np.stack([name_ends - name_len, name_ends], axis=1),
        path_steps=np.stack([bounds[:-1], bounds[1:]], axis=1),
        path_overlaps=np.zeros((p, 2), np.uint32),
        link_from=np.zeros(0, np.uint32),
        link_to=np.zeros(0, np.uint32),
        link_overlap=np.zeros((0, 2), np.uint32),
        steps=steps_h,
        seq_data=np.zeros(int(seq_bounds[-1]), np.uint8),
        overlaps=np.zeros((0, 2), np.uint32),
        alignment=np.zeros(0, np.uint32),
        name_data=np.frombuffer(names, np.uint8).copy(),
        optional_data=np.zeros(0, np.uint8),
        line_order=np.zeros(0, np.uint8),
    )
    return arena, None
