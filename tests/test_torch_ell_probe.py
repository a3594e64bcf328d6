"""The ELL query's permuted form and the port's two probes.

``seg_depth_with_uniq_ell_permuted`` (the parts as two vectors in the
index's own ``ell_order``, one concatenate on the graph's device) is
held against the reference's (``pollen_tpu.ops.depth``, ``pallas=False``)
on the fixtures and on generated graphs: fused, unfused, three-tier,
tiers-only and heavy-free plans, and an empty ``ell_order``; exact
(integer counts, tolerance 0). The probes' check stages report diff 0
at a tiny size on the CPU, and ``ellp16``/``ellp16ok`` report a number
on a heavy-free graph (the reference's copy unpacks four outputs of a
launch that returns two there, ``probes/ell_probe.py:386``). The
reference's probe scripts import ``bench`` and time the TPU, so they are
not run here.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXTURE_GRAPHS, GRAPH_DIR
from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import parse_gfa_file as ref_parse_gfa_file
from pollen_tpu.kernels import ellscan as ref_ellscan
from pollen_tpu.ops import depth as ref_depth
from pollen_tpu_torch.device import build_graph, from_host_arrays
from pollen_tpu_torch.kernels import ellscan as port_ellscan
from pollen_tpu_torch.ops import depth as port_depth
from pollen_tpu_torch.probes import ell_probe, transform_probe
from pollen_tpu_torch.synth import synth_graph
from test_torch_depth import three_tier_graph

torch.set_num_threads(1)

SYNTH = {
    # Over 8192 heavy columns: the fused split route (K1).
    "fused": (2**20, 2**16, 128),
    # A heavy block below SEG_BLOCK: the unfused route (K3 + K2).
    "unfused": (2**16, 2**12, 96),
}
TINY = (30000, 4096, 40)  # the probes' CPU size


def uniform_graph(n_steps=2**16, n_segs=2**13, n_paths=64, seed=9):
    """A synthetic graph whose steps visit segments uniformly (mean 8
    runs a segment, none near 32): under a forced (4, 16, 32) split every
    crossed segment lands in a tier, so the index has no heavy class."""
    g = synth_graph(n_steps, n_segs, n_paths)
    segs = np.random.default_rng(seed).integers(0, n_segs, n_steps)
    return dataclasses.replace(g, steps=segs.astype(np.uint32) << np.uint32(1))


HEAVY_FREE_KS = (4, 16, 32)


def forced_plan(monkeypatch, ks):
    """Both packages plan at the fixed split ``ks``, the rest heavy."""
    forced = ell_probe.forced_planner(ks)
    monkeypatch.setattr(port_ellscan, "plan_ell_tiers_n", forced)
    monkeypatch.setattr(ref_ellscan, "plan_ell_tiers_n", forced)


def load(case, monkeypatch):
    """(arena, the reference's host index) of a case."""
    if case in SYNTH:
        g = synth_graph(*SYNTH[case])
    elif case == "three_tier":
        for mod in (ref_ellscan, port_ellscan):
            monkeypatch.setattr(mod, "C_TIER_FIXED", 0.0)
            monkeypatch.setattr(mod, "C_COL_B", 0.0)
        g = three_tier_graph()
    elif case == "heavy_free":
        forced_plan(monkeypatch, HEAVY_FREE_KS)
        g = uniform_graph()
    else:
        g = ref_parse_gfa_file(str(GRAPH_DIR / case))
    return g, build_device_graph(g, device="host")


def masks_for(p, seed=0):
    rng = np.random.default_rng(seed)
    return [np.ones(p, bool), np.zeros(p, bool), rng.random(p) < 0.5,
            rng.random(p) < 0.2]


def unpermute(order: np.ndarray, v: np.ndarray) -> np.ndarray:
    if not order.shape[0]:
        return v
    out = np.empty_like(v)
    out[order] = v
    return out


CASES = FIXTURE_GRAPHS + sorted(SYNTH) + ["three_tier", "heavy_free"]


@pytest.mark.parametrize("case", CASES)
def test_permuted_matches_reference(case, monkeypatch):
    g, ref_dg = load(case, monkeypatch)
    fields = {f.name: getattr(ref_dg, f.name)
              for f in dataclasses.fields(ref_dg)}
    port_dgs = {"carried": from_host_arrays(fields, "cpu"),
                "built": build_graph(g, "cpu")}
    order = np.asarray(ref_dg.ell_order)
    if case == "three_tier":
        assert ref_dg.ell_k3 > 0 and ref_dg.ell_heavy.size
    if case == "heavy_free":
        assert ref_dg.ell_k3 > 0 and not ref_dg.ell_heavy.size
    if case == "tiny.gfa":
        assert not order.shape[0] and not ref_dg.ell_heavy.size
    if case == "fused":
        assert ref_dg.ell_heavy.shape[1] % 8192 == 0
    if case == "unfused":
        assert ref_dg.ell_heavy.size and ref_dg.ell_heavy.shape[1] % 8192
    for m in masks_for(g.num_paths):
        d_r, u_r = (np.asarray(x) for x in ref_depth
                    .seg_depth_with_uniq_ell_permuted(ref_dg, jnp.asarray(m),
                                                      pallas=False))
        d_x, u_x = (np.asarray(x) for x in ref_depth
                    .seg_depth_with_uniq_masked(ref_dg, jnp.asarray(m)))
        assert np.array_equal(unpermute(order, d_r), d_x)
        assert np.array_equal(unpermute(order, u_r), u_x)
        for how, dg in port_dgs.items():
            assert np.array_equal(dg.ell_order.numpy(), order), how
            for plain in (True, False):
                d, u = port_depth.seg_depth_with_uniq_ell_permuted(
                    dg, torch.from_numpy(m), plain=plain
                )
                assert d.dtype == u.dtype == torch.int32
                assert d.shape == (g.num_segments,), how
                assert np.array_equal(d.numpy(), d_r), (how, plain)
                assert np.array_equal(u.numpy(), u_r), (how, plain)


def test_permuted_empty_order_is_the_first_tier(monkeypatch):
    """With no order and no second part, the first tier's vectors are
    returned cut to the segments, as the reference does."""
    g, ref_dg = load("tiny.gfa", monkeypatch)
    dg = build_graph(g, "cpu")
    assert not dg.ell_order.shape[0] and not dg.cross_ell2.numel()
    m = torch.ones(g.num_paths, dtype=torch.int32)
    d, u = port_depth.seg_depth_with_uniq_ell_permuted(dg, m)
    d1, u1, *_ = port_depth.seg_depth_with_uniq_ell_parts(dg, m)
    assert torch.equal(d, d1[: g.num_segments])
    assert torch.equal(u, u1[: g.num_segments])


# -- the probes, on the CPU ---------------------------------------------


@pytest.fixture(scope="module")
def tiny_graph():
    return ell_probe.build(TINY, torch.device("cpu"))[1]


@pytest.fixture(scope="module")
def heavy_free_graph():
    with ell_probe.three_tiers(HEAVY_FREE_KS):
        dg = build_graph(uniform_graph(), "cpu")
    assert not dg.ell_heavy.numel() and dg.ell_pack16
    return dg


@pytest.mark.parametrize("stage", ["ellok", "ellbok", "ellp16ok"])
def test_check_stages_report_diff_0(stage, tiny_graph, heavy_free_graph):
    lines = []
    for dg in (tiny_graph, heavy_free_graph):
        res = ell_probe.run_stage(stage, None, dg, TINY[0], say=lines.append)
        assert res["diff"] == 0, lines
    assert all(f"{stage}: diff=0" in ln for ln in lines), lines


def test_three_tier_check_stage(monkeypatch):
    dg = ell_probe.build(TINY, torch.device("cpu"), forced_three=True)[1]
    assert dg.ell_k3 > 0
    res = ell_probe.run_stage("ellb3ok", None, dg, TINY[0], say=print)
    assert res["diff"] == 0


def test_forced_plan_is_undone():
    saved = port_ellscan.plan_ell_tiers_n
    with ell_probe.three_tiers():
        assert port_ellscan.plan_ell_tiers_n is not saved
    assert port_ellscan.plan_ell_tiers_n is saved


def test_ellp16_reports_a_number_without_a_heavy_class(heavy_free_graph):
    """The repaired crash: both pack16 stages answer on a heavy-free
    index, pack16 timed beside 32-bit slots of the same tier."""
    lines = []
    res = ell_probe.run_stage("ellp16", None, heavy_free_graph, 2**16,
                              say=lines.append)
    assert res["us"] > 0 and res["us32"] > 0 and not res["heavy"]
    ok = ell_probe.run_stage("ellp16ok", None, heavy_free_graph, 2**16,
                             say=lines.append)
    assert ok == dict(diff=0, clipped=0, heavy=False)
    assert "heavy class absent" in lines[0] and "ellp16ok: diff=0" in lines[1]


TIMED = [("ellk", None), ("heavyk", None), ("ell", None), ("ellraw", None),
         ("ellb", "8"), ("ellp16", None), ("ellcal1", "tier:1:1"),
         ("ellcal1", "heavy:4096"), ("ellcal1", "hrot:4096"),
         ("crossd", None), ("scanb", None), ("scanx", None), ("runsk", None)]


@pytest.mark.parametrize("stage,arg", TIMED)
def test_timed_stages_run_on_the_cpu(stage, arg, tiny_graph):
    lines = []
    res = ell_probe.run_stage(stage, arg, tiny_graph, TINY[0],
                              say=lines.append)
    assert lines and all(ln.startswith(stage) for ln in lines), lines
    rows = res.values() if stage == "ellb" else [res]
    for row in rows:
        assert row["us"] > 0 and row["clock"] == "host clock, cpu"
    if arg and arg.startswith("hrot"):
        assert "forced tiling has no meaning" in lines[0]


def test_calibration_fit_and_scatter(tiny_graph):
    lines = []
    cal = ell_probe.stage_ellcal(tiny_graph, tiers=((1, (1, 2)),),
                                 widths=(128, 256), say=lines.append)
    assert set(cal["tier"][1]) == {"points", "fixed_us", "ns_per_slot"}
    assert "heavy_ns_per_byte" in cal and lines[-1] == "ellcal: done"
    sc = ell_probe.stage_scatter(tiny_graph, ks=(256, 1024), say=lines.append)
    assert set(sc) == {256, 1024}


def test_fit_recovers_a_line():
    assert ell_probe.fit([1, 2, 4], [3, 5, 9]) == pytest.approx((1.0, 2.0))


def test_parse_stages():
    assert ell_probe.parse_stages(["ellok", "ellb", "32", "ellcal1",
                                   "tier:1:2"]) == [
        ("ellok", None), ("ellb", "32"), ("ellcal1", "tier:1:2")]
    with pytest.raises(ValueError):
        ell_probe.parse_stages(["nope"])


def test_ell_probe_cli_on_the_cpu(monkeypatch, capsys):
    for var, val in zip(("STEPS", "SEGS", "PATHS"), TINY):
        monkeypatch.setenv(f"POLLEN_BENCH_{var}", str(val))
    rc = ell_probe.main(["ellok", "ellbok", "ellb3ok", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "ellok: diff=0" in out and "ellb3ok: diff=0" in out
    assert "(three tiers forced)" in out


@pytest.mark.parametrize("stage", transform_probe.STAGES)
def test_transform_probe_stages_run_on_the_cpu(stage):
    g = synth_graph(*TINY)
    lines = []
    fn = getattr(transform_probe, f"stage_{stage}")
    res = fn(g, torch.device("cpu"), say=lines.append)
    assert res["equal"] and res["device_s"] > 0, lines
    assert lines[0].startswith(f"{stage}: host full")


def test_transform_probe_formulations_agree():
    """The torch stages equal the host stages and the real chop."""
    from pollen_tpu_torch.ops.transform import chop

    g = synth_graph(5000, 700, 6)
    lens = np.asarray(g.seg_len).astype(np.int64)
    steps = np.asarray(g.steps).astype(np.int64)
    ids = transform_probe.chop_ids_host(lens, steps, 3)
    got = transform_probe.chop_ids_device(
        torch.from_numpy(lens), torch.from_numpy(steps), 3, ids.shape[0]
    )
    assert np.array_equal(ids, got.numpy())
    out = chop(g, 3)
    assert ids.shape[0] == out.num_steps
    # The forward-order ids are the chopped steps' ids where no step is
    # reversed.
    fwd = (steps & 1) == 0
    owner = np.repeat(np.arange(steps.shape[0]),
                      ((lens + 2) // 3)[steps >> 1])
    new = (out.steps >> 1).astype(np.int64)
    assert np.array_equal(ids[fwd[owner]], new[fwd[owner]])
    rng = np.random.default_rng(1)
    seq = rng.choice(np.frombuffer(b"ACGTNN", np.uint8), 4000)
    starts = np.arange(0, 4000, 7)
    keep = transform_probe.crush_keep_host(seq, starts)
    assert np.array_equal(
        keep,
        transform_probe.crush_keep_device(torch.from_numpy(seq),
                                          torch.from_numpy(starts)).numpy(),
    )
