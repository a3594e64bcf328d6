"""The plain reference against the port's answers on tiny graphs on the
CPU, through both public entries and every route; and the control,
which has to differ from the reference."""

import numpy as np
import pytest

from conftest import tiny_config
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.ops import depth as depth_op
from portbench import reference, registry

ROUTES = ["ell", "cross", "scan", "xla", "runs"]


@pytest.fixture(scope="module")
def graph():
    g, _ = registry.shape("bubble_chain").draw(tiny_config("hprc_chr8"), 11, "cpu")
    ref = reference.Reference(g.steps, g.path_steps, g.num_segments)
    uniform = registry.subsets("uniform")
    masks = uniform.MaskStream(
        uniform.mask_pool(6, g.num_paths, 11, "cpu"), g.num_paths).masks(0, 6)
    masks[0] = True  # every path
    masks[1] = False  # none
    return g, ref, masks


def _same(got, want):
    assert np.array_equal(np.asarray(got[0]), want[0])
    assert np.array_equal(np.asarray(got[1]), want[1])


@pytest.mark.parametrize("route", ROUTES)
def test_single_entry_every_route(graph, route, monkeypatch):
    g, ref, masks = graph
    dg = build_graph(g, "cpu", cross_matrix="always")
    monkeypatch.setattr(depth_op, "_best_masked_impl", lambda dg: route)
    for m in masks:
        _same(depth_op.masked_seg_depth(dg, m), ref.answer(m))


@pytest.mark.parametrize("build,route", [
    ({"cross_matrix": "always"}, "ell"),
    ({"cross_matrix": "always"}, "cross"),
    ({"cross_matrix": "never"}, "runs"),
])
def test_batch_entry_every_route(graph, build, route, monkeypatch):
    g, ref, masks = graph
    dg = build_graph(g, "cpu", **build)
    monkeypatch.setattr(depth_op, "_best_masked_impl",
                        lambda dg: "ell" if route == "ell" else "scan")
    assert depth_op.batch_route(dg) == route
    d, u = depth_op.seg_depth_with_uniq_batch(dg, masks)
    for j, m in enumerate(masks):
        _same((d[j], u[j]), ref.answer(m))


def test_reference_counts_each_step(graph):
    """All paths: depth sums to the step count, uniq to the runs."""
    g, ref, _ = graph
    depth, uniq = ref.answer(np.ones(g.num_paths, bool))
    assert depth.sum() == g.num_steps
    assert np.array_equal(depth, np.bincount(g.steps >> 1, minlength=g.num_segments))
    assert uniq.sum() == (ref.count > 0).sum()


def test_dense_and_runs_agree(graph, monkeypatch):
    """Both forms of the counts give the same answers, and the same
    control answers."""
    g, ref, masks = graph
    assert ref.count is not None
    monkeypatch.setattr(reference, "DENSE_LIMIT", 0)
    runs = reference.Reference(g.steps, g.path_steps, g.num_segments)
    assert runs.count is None
    for clip in (None, reference.CONTROL_CLIP):
        for got, want in zip(runs.answers(masks, clip), ref.answers(masks, clip)):
            assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["hprc_chr8"])
def test_control_fails(name):
    """The control (run counts held in a nibble, the overflow dropped)
    differs from the reference on every seed and mask tried, so the
    limit of 0 differences refuses it; the reference agrees with itself
    (a run's reading)."""
    cfg = tiny_config(name)
    uniform = registry.subsets("uniform")
    for seed in (1, 2, 3):
        g, _ = registry.shape(cfg["shape"]).draw(cfg, seed, "cpu")
        ref = reference.Reference(g.steps, g.path_steps, g.num_segments)
        masks = uniform.MaskStream(
            uniform.mask_pool(4, g.num_paths, seed, "cpu"), g.num_paths).masks(0, 4)
        for m in masks:
            want = ref.answer(m)
            ctl = ref.control_answer(m)
            assert reference.differences(*ctl, want)["depth"] > 0
            assert reference.differences(*want, want) == {"depth": 0, "uniq": 0}


def test_differences_counts_wrong_shapes():
    want = (np.arange(5), np.arange(5))
    assert reference.differences(np.arange(4), np.arange(5), want) == {
        "depth": 5, "uniq": 0}


@pytest.mark.parametrize("cell", ["hprc_chr8.single", "hprc_chr8.batch32"])
def test_control_run_is_not_correct(cell):
    """``python -m portbench.control``'s run, on a tiny stand-in of the
    cell's configuration: the control in the program's place, through
    the harness's own window, check and result, comes out not correct
    on depth, and on nothing else."""
    from portbench import control, harness, registry

    w = registry.workload(cell)
    tr = registry.traffic(w["traffic"])
    tr.update(pool=64, check_calls=4)
    run, out = harness.run_cell(cell, 2**31 + 3, 0.3, False, "cpu",
                                config=tiny_config(w["config"]), traffic=tr,
                                fault=control.control)
    assert not out["correct"]
    assert out["checks"]["depth_diff"]["value"] > 0
    assert out["checks"]["uniq_diff"]["value"] == 0
    assert run.answers_checked >= 1 and out["failed"] == 0
