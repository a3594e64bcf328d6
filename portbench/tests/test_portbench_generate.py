"""The device generators: the bubble-chain shape deterministic for a
seed, with counts as the configuration states for every seed, haplotype
walks of a bubble chain, and the same bytes as before it moved behind
the shape interface; the uniform kind's masks as the mix states, the
same bytes as before."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from conftest import tiny_config
from portbench import registry

SEEDS = [0, 2**31 + 7, 2**40 + 3]
CHAIN = registry.shape("bubble_chain")
UNIFORM = registry.subsets("uniform")
# Digests of the arena's arrays and of the uniform kind's pools and
# requests 4090-4129 (past the pool's 4096: rotated), computed with the
# generator and mask pool as they stood before the shape and subset
# interfaces, at tiny_config("hprc_chr8"): the move changed no byte.
GOLDEN = {
    0: ("83deff851cc1b4b9086d0079bd89f914", {
        "single": ("111ea157018ea055d1f5c62df9f29b0c", "caceb490dacd0fd169e7eb1ea65591e8",
                   "8ff59fe702d9c7dad51a0ac88adf0916"),
        "batch32": ("111ea157018ea055d1f5c62df9f29b0c", "1846709cf10f06cb49e2a86b6dc28ee8",
                    "8ff59fe702d9c7dad51a0ac88adf0916")}),
    2**31 + 7: ("79bd95c2274d37b4649ac4f02f5950f8", {
        "single": ("a2d61febf15a3cf6519eb3fc6d8936ce", "57d2fea135970273a329edcfe69cba54",
                   "4c2099684aa7b26b00b79d1b23b0ad2b"),
        "batch32": ("a2d61febf15a3cf6519eb3fc6d8936ce", "6a38c65c94c90927fa7bf580a2767f00",
                    "4c2099684aa7b26b00b79d1b23b0ad2b")}),
    2**40 + 3: ("2f0745e6ce1c23115decf5ad5b47baf7", {
        "single": ("1b8d2bba990a8b96f50c38a82d41863a", "c1b5bbf029b3c9d1a4624dce5e2c20b4",
                   "dc5f70c1e46cc24c7ca56f6050d574eb"),
        "batch32": ("1b8d2bba990a8b96f50c38a82d41863a", "59644571c9ea00b4c8e625ad9abfba52",
                    "dc5f70c1e46cc24c7ca56f6050d574eb")}),
}


def digest(arrays: dict) -> str:
    """One digest of named arrays: each name, dtype, shape and bytes."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(f"{name}:{a.dtype.str}:{a.shape}:".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:32]


def test_stated_counts_are_the_plans():
    for c in registry.benchmark()["configs"]:
        cfg = registry.config(c["name"])
        assert registry.shape(cfg["shape"]).sizes(cfg) == (cfg["segments"], cfg["steps"])


@pytest.mark.parametrize("seed", SEEDS)
def test_golden_bytes(seed):
    cfg = tiny_config("hprc_chr8")
    g, groups = CHAIN.draw(cfg, seed, "cpu")
    assert groups is None
    arena, kinds = GOLDEN[seed]
    assert digest({f.name: getattr(g, f.name) for f in dataclasses.fields(g)}) == arena
    for name, (pool, warm, requests) in kinds.items():
        tr = registry.traffic(name)
        window, warmup = UNIFORM.streams(tr, g.num_paths, groups, seed, "cpu")
        assert digest({"pool": window.pool}) == pool
        assert digest({"warm": warmup.pool}) == warm
        assert digest({"r": window.masks(4090, 40)}) == requests


@pytest.mark.parametrize("seed", SEEDS)
def test_arena_deterministic_and_counts(seed):
    cfg = tiny_config("hprc_chr8")
    a, _ = CHAIN.draw(cfg, seed, "cpu")
    b, _ = CHAIN.draw(cfg, seed, "cpu")
    assert np.array_equal(a.steps, b.steps)
    assert np.array_equal(a.seg_seq, b.seg_seq)
    assert np.array_equal(a.path_steps, b.path_steps)
    assert (a.num_steps, a.num_segments, a.num_paths) == (
        cfg["steps"], cfg["segments"], cfg["paths"])
    assert a.steps.dtype == np.uint32
    lens = a.path_steps[:, 1].astype(np.int64) - a.path_steps[:, 0]
    assert lens.sum() == cfg["steps"] and (a.path_steps[1:, 0] == a.path_steps[:-1, 1]).all()
    lo, hi = cfg["segment_bp"]
    assert a.seg_len.min() >= lo and a.seg_len.max() <= hi
    c, _ = CHAIN.draw(cfg, seed + 1, "cpu")
    assert not np.array_equal(a.steps, c.steps)
    assert (c.num_steps, c.num_segments) == (a.num_steps, a.num_segments)


@pytest.mark.parametrize("seed", SEEDS)
def test_haplotypes_walk_the_chain(seed):
    """Each path walks the sites in order (outside the inversion, a step
    goes back only inside a loop's unit), visits every backbone segment
    once, and reverses exactly its steps inside the inversion; every
    segment is visited; only loops give a path more than one visit."""
    cfg = tiny_config("hprc_chr8")
    g, _ = CHAIN.draw(cfg, seed, "cpu")
    p, seg, rev = g.num_paths, (g.steps >> 1).astype(np.int64), g.steps & 1
    unit_max = cfg["vntr_unit_segments"][1]
    everyone = None
    carriers = 0
    for lo, hi in g.path_steps.astype(np.int64):
        s, r = seg[lo:hi], rev[lo:hi]
        fwd = s[r == 0]
        assert np.diff(fwd).min() >= -(unit_max - 1)
        if r.any():
            carriers += 1
            back = s[r == 1]
            assert np.ptp(np.flatnonzero(r)) + 1 == back.size  # one stretch
            assert np.diff(back).max() <= unit_max - 1
        visited = set(s.tolist())
        everyone = visited if everyone is None else everyone & visited
    assert carriers == round(cfg["inversion"]["carrier_share"] * p)
    loops = int(cfg["site_kinds"]["vntr"] * cfg["sites"])
    # The backbone and the loops' units.
    assert cfg["sites"] <= len(everyone) <= cfg["sites"] + loops * unit_max
    owner = np.repeat(np.arange(p), np.diff(g.path_steps.astype(np.int64), axis=1)[:, 0])
    count = np.bincount(owner * g.num_segments + seg,
                        minlength=p * g.num_segments).reshape(p, -1)
    assert (count > 0).sum(0).min() >= 1 and (count > 0).sum(0).max() <= p
    assert loops >= 1 and count.max() > 15  # past a nibble
    assert count.max() <= 2 * cfg["vntr_copies"][1] - 1


def test_plan_follows_the_configuration():
    cfg = registry.config("hprc_chr8")
    pl = CHAIN.plan(cfg)
    s = cfg["sites"]
    for k, share in cfg["site_kinds"].items():
        got = np.count_nonzero(pl["kind"] == CHAIN.KINDS.index(k)) / s
        assert abs(got - share) < 1e-5
    ins = pl["unit"][pl["kind"] == CHAIN.INS]
    assert abs(ins.mean() - cfg["ins_segments"]) < 0.01
    k = pl["carriers"][pl["kind"] != CHAIN.VNTR]
    assert k.min() >= 1 and k.max() <= cfg["paths"] - 1
    h = np.sum(1.0 / np.arange(1, cfg["paths"]))
    assert abs(k.mean() - (cfg["paths"] - 1) / h) < 0.05


@pytest.mark.parametrize("mean", [1, 2, 7, 40])
def test_loop_copies_total_is_fixed(mean):
    ranks = np.arange(96)
    c = CHAIN._loop_copies(ranks, mean, 96)
    assert c.min() >= 1 and c.max() <= 2 * mean - 1
    assert abs(c.mean() - mean) < 0.5


@pytest.mark.parametrize("n_paths", [96, 1 << 16, 13])
def test_mask_pool(n_paths, monkeypatch):
    monkeypatch.setattr(UNIFORM, "MASK_ROWS", 16)  # several draws a pool
    pool = UNIFORM.mask_pool(40, n_paths, 2**33, "cpu")
    again = UNIFORM.mask_pool(40, n_paths, 2**33, "cpu")
    assert np.array_equal(pool, again)
    assert pool.shape == (40, -(-n_paths // 8))
    stream = UNIFORM.MaskStream(pool, n_paths)
    masks = stream.masks(0, 40)
    sizes = masks.sum(1)
    assert masks.shape == (40, n_paths) and masks.dtype == bool
    assert sizes.min() >= 1 and sizes.max() <= n_paths
    # Each seed asks for the same multiset of sizes, in its own order.
    want = UNIFORM.pool_sizes(40, n_paths)
    assert np.array_equal(np.sort(sizes), want)
    other = UNIFORM.MaskStream(UNIFORM.mask_pool(40, n_paths, 5, "cpu"),
                               n_paths).masks(0, 40).sum(1)
    assert np.array_equal(np.sort(other), want)
    assert not np.array_equal(other, sizes)
    # Past the pool, a request is a rotation of a pool mask.
    assert np.array_equal(stream.mask(40 + 3), np.roll(stream.mask(3), 1))
    assert stream.mask(40 + 3).sum() == stream.mask(3).sum()
