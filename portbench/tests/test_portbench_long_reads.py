"""The ``long_reads`` shape and the ``read_groups`` subset kind of the
``chr8_ont_reads`` configuration: fixed sizes for every seed, reads that
are windows of their sample's haplotype walks (reverse reads walked
backwards, orientations flipped), contiguous read groups, whole-group
masks, and whole runs of both cells on the CPU through the real files,
correct with the program and not correct with the control. On the card
(marked ``card``), the full-size graph takes the scan and runs routes."""

import numpy as np
import pytest

from portbench import control, harness, registry
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.ops import depth

CONFIG = "chr8_ont_reads"
CELLS = ["chr8_ont_reads.single", "chr8_ont_reads.batch32"]
SEEDS = [2**31 + 3, 7, 2**33 + 1]
SHAPE = registry.shape(registry.config(CONFIG)["shape"])


def tiny() -> dict:
    """The configuration over a 400-site chain (chr8's 310 bp a site)
    and reads of a 8 kb mean: 1,395 reads of about 55 steps, 12 groups."""
    cfg = registry.config(CONFIG)
    cfg["chain"]["sites"] = 400
    cfg["genome_bp"] = 400 * 310
    cfg["read_bp"] = dict(cfg["read_bp"], mean=8000)
    cfg["segments"], cfg["steps"] = SHAPE.sizes(cfg)
    cfg["paths"] = cfg["samples"] * SHAPE.read_steps(cfg).size
    return cfg


def small_traffic(name: str) -> dict:
    return dict(registry.traffic(name), pool=64, check_calls=4, trace_calls=2)


def test_file_states_its_sizes():
    cfg = registry.config(CONFIG)
    assert (cfg["segments"], cfg["steps"]) == SHAPE.sizes(cfg)
    assert cfg["paths"] == cfg["samples"] * SHAPE.read_steps(cfg).size > 1 << 16
    assert set(registry.workload(c)["config"] for c in CELLS) == {CONFIG}


@pytest.mark.parametrize("seed", SEEDS)
def test_sizes_are_the_same_for_every_seed(seed):
    cfg = tiny()
    g, groups = SHAPE.draw(cfg, seed, "cpu")
    assert (g.num_paths, g.num_segments, g.num_steps) == (
        cfg["paths"], cfg["segments"], cfg["steps"])
    lens = np.diff(g.path_steps.astype(np.int64), axis=1)[:, 0]
    per = cfg["paths"] // cfg["samples"]
    for s in range(cfg["samples"]):
        assert np.array_equal(np.sort(lens[s * per : (s + 1) * per]), SHAPE.read_steps(cfg))
    assert groups.shape == (g.num_paths,)


def _found(read, walk) -> bool:
    """Whether ``read`` is a contiguous window of ``walk``."""
    n = read.size
    for at in np.flatnonzero(walk[: walk.size - n + 1] == read[0]):
        if np.array_equal(walk[at : at + n], read):
            return True
    return False


def test_reads_are_windows_of_their_samples_walks():
    cfg = tiny()
    seed = SEEDS[0]
    g, groups = SHAPE.draw(cfg, seed, "cpu")
    chain, _ = registry.shape(cfg["chain"]["shape"]).draw(cfg["chain"], seed, "cpu")
    h, f = cfg["haplotypes_per_sample"], cfg["flow_cells"]
    walks = [chain.steps[lo:hi] for lo, hi in chain.path_steps.astype(np.int64)]
    strands = [0, 0]
    for r, (lo, hi) in enumerate(g.path_steps.astype(np.int64)):
        read = g.steps[lo:hi]
        sample = groups[r] // f
        mine = walks[sample * h : (sample + 1) * h]
        forward = any(_found(read, w) for w in mine)
        backward = any(_found(read[::-1] ^ np.uint32(1), w) for w in mine)
        assert forward or backward, r
        strands[backward and not forward] += 1
    # Both strands occur, about half each.
    assert min(strands) > 0.4 * g.num_paths


def test_groups_are_contiguous_and_ordered():
    cfg = tiny()
    _, groups = SHAPE.draw(cfg, SEEDS[1], "cpu")
    g = cfg["samples"] * cfg["flow_cells"]
    assert (np.diff(groups) >= 0).all() and set(groups) == set(range(g))
    sizes = np.bincount(groups)
    assert sizes.max() - sizes.min() <= 1
    per = cfg["paths"] // cfg["samples"]
    assert np.array_equal(groups // cfg["flow_cells"], np.arange(cfg["paths"]) // per)


@pytest.mark.parametrize("traffic", ["groups_single", "groups_batch32"])
def test_requests_are_whole_groups(traffic):
    cfg = tiny()
    g, groups = SHAPE.draw(cfg, SEEDS[0], "cpu")
    kind = registry.subsets(registry.traffic(traffic)["subsets"])
    window, warm = kind.streams(small_traffic(traffic), g.num_paths, groups, 11, "cpu")
    n_groups = int(groups.max()) + 1
    starts = np.searchsorted(groups, np.arange(n_groups))
    masks = window.masks(60, 8)  # across the end of the 64-row pool
    for j, m in enumerate(masks):
        sel = m[starts]  # each group's first read
        assert sel.any() and np.array_equal(m, sel[groups])
        assert np.array_equal(m, window.mask(60 + j))
    counts = sorted(int(m[starts].sum()) for m in window.masks(0, 64))
    assert counts == sorted(kind.counts(64, n_groups))
    assert warm.masks(0, 2).shape == (2, g.num_paths)


def _run(cell, fault=None, seed=2**31 + 41):
    w = registry.workload(cell)
    return harness.run_cell(cell, seed, 1.0, False, "cpu", config=tiny(),
                            traffic=small_traffic(w["traffic"]), fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_run_is_correct(cell):
    run, out = _run(cell)
    assert out["correct"], out["checks"]
    assert run.answers_checked >= 1 and out["failed"] == 0
    assert 0 < run.stages["requests_s"] < run.window_s


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    run, out = _run(cell, fault=control.control)
    assert not out["correct"], out["checks"]
    assert out["checks"]["depth_diff"]["value"] > 0


@pytest.mark.card
def test_full_size_routes_scan_and_runs(card):
    cfg = registry.config(CONFIG)
    g, _ = SHAPE.draw(cfg, SEEDS[0], card)
    assert (g.num_paths, g.num_segments, g.num_steps) == (
        cfg["paths"], cfg["segments"], cfg["steps"])
    dg = build_graph(g, card)
    assert not dg.cross_ell.numel() and not dg.cross_matrix.numel()
    assert depth.masked_route_fn(dg)[0] == "scan"
    assert depth.batch_route_fn(dg)[0] == "runs"
