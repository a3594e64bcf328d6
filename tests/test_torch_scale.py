"""The port's scale tests: the counterpart of ``tests/test_scale.py``.

Gated behind POLLEN_SCALE_TEST=1 (``make test-scale-torch``), as the
reference's are, so that Tier-1 stays fast:

(a) an 8M-step graph (2^23 steps, 2^19 segments, 256 paths) through
    ingest and the routed all-paths query on the CPU, which must sum to
    the step count, equal numpy's count from the arena, and equal the
    sharded query of a 2-rank gloo job;
(b) the chr8-shaped run of ``pollen_tpu_torch.probes.scale`` on the CPU
    at POLLEN_CHR8_STEPS steps (default 10^8), every stage exact against
    numpy and against its plain form.

Ungated (Tier-1): the same check function at 2^16 steps, 2^12 segments
and 96 paths, each stage's answers held against the reference's
``bench.synth_device_graph`` and ``seg_depth_with_uniq_masked`` (JAX on
the CPU), exactly; and the run fails, never falls back, where it must.
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_jobs
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.ops import depth as depth_op
from pollen_tpu_torch.parallel import launch
from pollen_tpu_torch.probes import scale
from pollen_tpu_torch.synth import synth_graph

gated = pytest.mark.skipif(
    os.environ.get("POLLEN_SCALE_TEST") != "1",
    reason="set POLLEN_SCALE_TEST=1 to run the scale smoke",
)

SMALL = (2**16, 2**12, 96)


@gated
def test_scale_depth_pipeline():
    n_steps, n_segs, n_paths = 2**23, 2**19, 256
    t0 = time.perf_counter()
    g = synth_graph(n_steps, n_segs, n_paths)
    dg = build_graph(g, "cpu")
    build_time = time.perf_counter() - t0
    assert build_time < 120, f"ingest too slow: {build_time:.1f}s"

    d1, u1 = depth_op.masked_seg_depth(dg, np.ones(n_paths, bool))
    assert int(d1.sum()) == n_steps
    want_d, want_u = scale.NumpyTruth(g).answer(np.ones(n_paths, bool))
    np.testing.assert_array_equal(np.asarray(d1), want_d)
    np.testing.assert_array_equal(np.asarray(u1), want_u)
    job = launch.run(torch_rank_jobs.scale_sharded, 2, n_steps, n_segs,
                     n_paths, device="cpu", deadline=900)
    for rank in job:
        assert rank["foreign_modules"] == []
        for form in ("seg", "fused"):
            dm, um = rank[form]
            np.testing.assert_array_equal(dm, d1)
            np.testing.assert_array_equal(um, u1)


@gated
def test_chr8_shaped_synthetic():
    n_steps = int(os.environ.get("POLLEN_CHR8_STEPS", scale.CHR8_STEPS))
    run = scale.run_checks(n_steps, device="cpu")
    assert run.stages["batch"]["q"] == scale.BATCH_Q


@pytest.fixture(scope="module")
def small_run():
    return scale.run_checks(*SMALL, device="cpu", keep=True)


@pytest.fixture(scope="module")
def reference():
    import bench

    return bench.synth_device_graph(*SMALL)


def ref_answer(ref_dg, mask):
    from pollen_tpu.ops import depth as ref_depth

    d, u = ref_depth.seg_depth_with_uniq_masked(ref_dg, jnp.asarray(mask))
    return np.asarray(d), np.asarray(u)


def test_small_run_arena_and_plan_match_reference(small_run, reference):
    g_ref, ref_dg = reference
    g = synth_graph(*SMALL, seed=scale.SEED)
    np.testing.assert_array_equal(g.steps, np.asarray(g_ref.steps))
    np.testing.assert_array_equal(g.path_steps, np.asarray(g_ref.path_steps))
    np.testing.assert_array_equal(g.seg_len, np.asarray(g_ref.seg_len))
    plan = small_run.answers["plan"]
    assert plan["classes"] == (ref_dg.ell_num_light, ref_dg.ell_num_mid,
                               ref_dg.ell_num_mid2, ref_dg.ell_num_heavy)
    assert plan["ks"] == (ref_dg.ell_k, ref_dg.ell_k2, ref_dg.ell_k3)
    assert plan["tier_slots"] and sum(plan["classes"]) <= SMALL[1]


@pytest.mark.parametrize(
    "stage", ["routed", "ell_plain", "scan", "scan_plain", "runs", "runs_plain"]
)
def test_small_run_stage_matches_reference(small_run, reference, stage):
    _, ref_dg = reference
    want = ref_answer(ref_dg, scale.routed_mask(SMALL[2]))
    got = small_run.answers[stage]
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_small_run_batch_matches_reference(small_run, reference):
    _, ref_dg = reference
    masks = scale.batch_masks(SMALL[2])
    assert masks.shape == (scale.BATCH_Q, SMALL[2])
    got_d, got_u = small_run.answers["batch"]
    for q in range(masks.shape[0]):
        want_d, want_u = ref_answer(ref_dg, masks[q])
        np.testing.assert_array_equal(got_d[q], want_d)
        np.testing.assert_array_equal(got_u[q], want_u)
    assert int(got_d[0].sum()) == SMALL[0] and not got_d[1].any()


def test_small_run_reports_every_stage(small_run):
    assert list(small_run.stages) == [
        "synth", "ingest", "numpy", "plan", "routed", "ell_plain", "scan",
        "runs", "batch",
    ]
    assert small_run.stages["ingest"]["index_bytes"] > 0


def test_scale_run_raises_on_a_wrong_answer(monkeypatch):
    real = depth_op.masked_seg_depth

    def off_by_one(dg, mask):
        d, u = real(dg, mask)
        d = d.copy()
        d[-1] += 1
        return d, u

    monkeypatch.setattr(depth_op, "masked_seg_depth", off_by_one)
    with pytest.raises(scale.ScaleCheckError, match="routed"):
        scale.run_checks(2**12, 2**8, 8, "cpu")


@pytest.mark.parametrize("field", ["count", "path"])
@pytest.mark.parametrize("pack16", ["1", "0"])
def test_plan_check_catches_a_wrong_slot(monkeypatch, pack16, field):
    """A slot whose count or path id is off (as a 16-bit, or pack16's
    8-bit, field that overflowed would be) fails the planner check."""
    monkeypatch.setenv("POLLEN_ELL_PACK16", pack16)
    g = synth_graph(*SMALL, seed=scale.SEED)
    dg = build_graph(g, "cpu")
    assert dg.ell_pack16 == int(pack16) and dg.cross_ell.numel()
    truth = scale.NumpyTruth(g)
    assert scale.check_plan(dg, truth)["tier_slots"]
    words = dg.cross_ell.view(-1)
    half = 0xFFFF if dg.ell_pack16 else -1  # the slot a word's low bits hold
    at = int(torch.nonzero(words & half)[0])
    shift = 8 if dg.ell_pack16 else scale._ell.COUNT_BITS
    words[at] += 1 if field == "count" else 1 << shift
    with pytest.raises(scale.ScaleCheckError, match="tier 1"):
        scale.check_plan(dg, truth)


def test_scale_entry_refuses_cuda_without_a_card(monkeypatch):
    """The entry runs on the card by default and never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scale.main(["--steps", "4096"])
