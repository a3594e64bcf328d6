"""A second graph shape and a second subset kind, defined here and not
under ``portbench/shapes`` or ``portbench/subsets``: reads as windows of
a tiny bubble chain's haplotype walks, more than 2^16 of them, and masks
of whole groups (``read_windows.py``, ``whole_groups.py``). The harness
takes them by name, with no edit to its files, and a whole run on the
CPU comes out correct; at that P the reference's run-list form answers
as its dense form does, and at P = 2^20 it holds run lists."""

import numpy as np
import pytest

import read_windows
import whole_groups
from conftest import tiny_config
from portbench import harness, reference, registry

# 96 haplotypes of a 100-site chain, 700 reads of 8 steps each: 67,200
# paths, 537,600 steps.
READS = dict(shape="read_windows", sites=100, read_steps=8, reads_per_haplotype=700)


def reads_config() -> dict:
    cfg = tiny_config("hprc_chr8")
    cfg.update(READS)
    cfg["segments"], cfg["steps"] = read_windows.sizes(cfg)
    return cfg


def reads_traffic(name: str) -> dict:
    return dict(registry.traffic(name), subsets="whole_groups", pool=64, check_calls=4)


@pytest.fixture
def found(monkeypatch):
    """The registry finds the two modules here by their names, as it
    finds a file under ``shapes/`` or ``subsets/``."""
    for kind, name, module in (("shape", "read_windows", read_windows),
                               ("subsets", "whole_groups", whole_groups)):
        real = getattr(registry, kind)
        monkeypatch.setattr(registry, kind,
                            lambda n, real=real, name=name, module=module:
                            module if n == name else real(n))


@pytest.mark.parametrize("cell", ["hprc_chr8.single", "hprc_chr8.batch32"])
def test_reads_run_is_correct(found, cell):
    cfg = reads_config()
    assert cfg["paths"] * cfg["reads_per_haplotype"] > 1 << 16
    w = registry.workload(cell)
    # whole_groups refuses a path count other than the arena's, so the
    # harness's P is the arena's 67,200, not the configuration's 96.
    run, out = harness.run_cell(cell, 2**31 + 17, 1.0, False, "cpu", config=cfg,
                                traffic=reads_traffic(w["traffic"]))
    assert out["correct"], (run.route, out["checks"])
    assert run.answers_checked >= 1 and out["attempted"] >= 1 and out["failed"] == 0
    assert 0 < run.stages["requests_s"] < run.window_s


def test_reads_masks_and_reference_forms(monkeypatch):
    cfg = reads_config()
    g, groups = read_windows.draw(cfg, 5, "cpu")
    assert g.num_paths == groups.size > 1 << 16
    assert (g.num_steps, g.num_segments) == (cfg["steps"], cfg["segments"])
    window, warm = whole_groups.streams(reads_traffic("single"), g.num_paths, groups, 5, "cpu")
    masks = window.masks(60, 8)  # across the end of the 64-row pool
    sizes = np.bincount(groups)
    for m in masks:
        picked = np.bincount(groups[m], minlength=sizes.size)
        assert m.any() and set(np.flatnonzero(picked)) == set(np.flatnonzero(picked == sizes))
    dense = reference.Reference(g.steps, g.path_steps, g.num_segments)
    assert dense.count is not None
    monkeypatch.setattr(reference, "DENSE_LIMIT", 0)
    runs = reference.Reference(g.steps, g.path_steps, g.num_segments)
    assert runs.count is None
    for clip in (None, reference.CONTROL_CLIP):
        for got, want in zip(runs.answers(masks, clip), dense.answers(masks, clip)):
            assert np.array_equal(got, want)


def test_reference_holds_runs_at_2e20_paths():
    p, n, per = 1 << 20, 1000, 3
    rng = np.random.default_rng(2**31 + 1)
    seg = rng.integers(0, n, p * per)
    steps = (seg << 1).astype(np.uint32)
    ends = np.arange(1, p + 1, dtype=np.uint32) * per
    ref = reference.Reference(steps, np.stack([ends - per, ends], axis=1), n)
    assert ref.count is None
    mask = rng.random(p) < 0.3
    sel = np.repeat(mask, per)
    depth, uniq = ref.answer(mask)
    assert np.array_equal(depth, np.bincount(seg[sel], minlength=n))
    owner = np.repeat(np.arange(p), per)[sel]
    assert np.array_equal(uniq, np.bincount(np.unique(owner * n + seg[sel]) % n, minlength=n))
