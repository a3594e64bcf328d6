"""The port's scan family (segment scan K6, boundary gather K7, run scan
K8) against the JAX reference on the CPU: each kernel's plain version
(what its wrapper runs on a CPU tensor) against the reference's Pallas
kernel in interpret mode, the "scan" and "runs" routes end to end on
the fixtures and on a state carried over from the reference's host
ingest, the goldens through ``fgfa-torch`` with the ELL and crossing-
matrix indexes budgeted away, and a graph past 2^16 paths that routes
"scan". Inputs are made from seeds with numpy. All comparisons are
exact (int32 counts, tolerance 0; text byte for byte).
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXTURE_GRAPHS, GOLDEN_DIR, GRAPH_DIR
from pollen_tpu.device import build_device_graph
from pollen_tpu.device import boundary_diff as ref_boundary_diff
from pollen_tpu.flatgfa import parse_gfa_file
from pollen_tpu.kernels import gatherb as ref_gatherb
from pollen_tpu.kernels.runscan import masked_run_cumsums as ref_run_cumsums
from pollen_tpu.kernels.segscan import BLOCK
from pollen_tpu.kernels.segscan import depth_uniq_from_cumsums as ref_from_cumsums
from pollen_tpu.kernels.segscan import masked_depth_cumsums as ref_depth_cumsums
from pollen_tpu.ops import depth as ref_depth
from pollen_tpu_torch.device import build_graph, from_host_arrays
from pollen_tpu_torch.kernels import gatherb, runscan, segscan
from pollen_tpu_torch.ops import depth as port_depth
from pollen_tpu_torch.synth import synth_graph
from test_torch_depth import run_cli

torch.set_num_threads(1)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_equal(ref, port):
    assert port.dtype == torch.int32
    assert np.array_equal(np.asarray(ref), port.numpy())


def random_case(s, p, n, seed):
    """A sorted step list of s steps over p paths and n segments, with
    its group starts and segment bounds."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, n, s)).astype(np.int32)
    path = rng.integers(0, p, s).astype(np.int32)
    order = np.lexsort((path, seg))
    seg, path = seg[order], path[order]
    new = np.concatenate(([True], (seg[1:] != seg[:-1]) | (path[1:] != path[:-1])))
    starts = np.flatnonzero(new)
    run_start = starts[np.cumsum(new) - 1].astype(np.int32)
    bounds = np.searchsorted(seg, np.arange(n + 1)).astype(np.int32)
    return path, run_start, bounds


def padded_mask(p, seed):
    """0/1 int32 over p paths, padded to a multiple of 128 (the padding
    sentinel path p reads 0), as the reference's callers pass it."""
    rng = np.random.default_rng(seed + 100)
    mask = np.zeros(-(-(p + 1) // 128) * 128, np.int32)
    mask[:p] = rng.integers(0, 2, p)
    return mask


def check_seg_scan(path, run_start, mask, head_carry=0, bounds=None):
    ref = ref_depth_cumsums(
        jnp.asarray(path), jnp.asarray(run_start), jnp.asarray(mask),
        interpret=True, head_carry=jnp.int32(head_carry),
    )
    port = segscan.masked_depth_cumsums(t(path), t(run_start), t(mask), head_carry)
    for a, b in zip(ref, port):
        assert_equal(a, b)
    if bounds is not None:
        for a, b in zip(
            ref_from_cumsums(*ref, jnp.asarray(bounds)),
            segscan.depth_uniq_from_cumsums(*port, t(bounds)),
        ):
            assert_equal(a, b)


# p = 60 and 200 take the reference's bit-select mask, 2040 its deepest
# select chain (64 words), 2300 its one-hot fallback; 1-3 scan blocks.
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("p", [60, 200, 2040, 2300])
def test_seg_scan_matches_reference(seed, p):
    path, run_start, bounds = random_case((seed + 1) * BLOCK, p, 37, seed)
    check_seg_scan(path, run_start, padded_mask(p, seed), bounds=bounds)


def test_seg_scan_group_spans_three_blocks():
    s = 3 * BLOCK
    path = np.zeros(s, np.int32)
    run_start = np.zeros(s, np.int32)
    mask = np.zeros(128, np.int32)
    mask[0] = 1
    check_seg_scan(path, run_start, mask, bounds=np.array([0, s], np.int32))
    d, u = segscan.depth_uniq_from_cumsums(
        *segscan.masked_depth_cumsums(t(path), t(run_start), t(mask)),
        t(np.array([0, s], np.int32)),
    )
    assert (int(d[0]), int(u[0])) == (s, 1)


@pytest.mark.parametrize("head_carry", [0, 1, 2])
def test_seg_scan_head_carry(head_carry):
    """A shard's local run_start: the leading group began 5 steps to
    the left (negative entries, never a start); later groups start here,
    one of them across the block boundary."""
    rng = np.random.default_rng(head_carry)
    s = 2 * BLOCK
    path = np.full(s, 3, np.int32)
    run_start = np.full(s, -5, np.int32)
    for start in (700, BLOCK - 300, BLOCK + 4000):
        path[start:] = rng.integers(0, 8)
        run_start[start:] = start
    mask = np.zeros(128, np.int32)
    mask[:8] = rng.integers(0, 2, 8)
    mask[3] = 1
    check_seg_scan(path, run_start, mask, head_carry)
    _, csf = segscan.masked_depth_cumsums(t(path), t(run_start), t(mask), head_carry)
    # The leading group's first selected step fires here only at carry 0.
    assert int(csf[699]) == (1 if head_carry == 0 else 0)


@pytest.mark.parametrize("head_carry", [0, 1, 2])
@pytest.mark.parametrize("layout", ["one group", "start every 7"])
def test_seg_scan_long_groups_match_reference(layout, head_carry):
    """Inputs that make the card's single-pass scan look back far: one
    group over 2 BLOCK steps (16 of the kernel's 2048-step partitions,
    none with a group start) under the all-ones mask, and a group start
    every 7 steps; the leading group began to the left (negative
    run_start), so the head carry decides its first flag."""
    s = 2 * BLOCK
    pos = np.arange(s, dtype=np.int32)
    mask = np.zeros(128, np.int32)
    if layout == "one group":
        path = np.zeros(s, np.int32)
        run_start = np.full(s, -5, np.int32)
        mask[0] = 1
    else:
        path = ((pos + 3) // 7 % 5).astype(np.int32)
        run_start = pos - (pos + 3) % 7
        mask[[0, 2, 3]] = 1
    check_seg_scan(path, run_start, mask, head_carry)
    csw, csf = segscan.masked_depth_cumsums(t(path), t(run_start), t(mask), head_carry)
    if layout == "one group":
        assert np.array_equal(csw.numpy(), pos + 1)
        assert int(csf[-1]) == (1 if head_carry == 0 else 0)


def test_scan_sources_have_only_the_single_pass():
    """K6 and K8 both launch through launch_scan_single; the three-launch
    template is gone; the look-back polls until a descriptor decodes as
    AGG or PREFIX (any other flag is not ready)."""
    csrc = pathlib.Path(__file__).resolve().parents[1] / "pollen_tpu_torch" / "csrc"
    common = (csrc / "common.cuh").read_text()
    scan = (csrc / "scan.cu").read_text()
    for gone in ("scan_reduce", "scan_totals", "scan_down", "scan_blocks",
                 "launch_scan(", "TOTALS_THREADS"):
        assert gone not in common and gone not in scan, gone
    assert scan.count("launch_scan_single(op, mask,") == 2
    assert "while (__any_sync(0xFFFFFFFFu, !desc_ready(flag)))" in common


# Weighted sums that pass 2^31 and wrap, as the reference's int32 sums
# do: counts of 2^18 to 2^20 over two BLOCKs of runs, a dense and a sparse
# mask; and the all-ones mask on one path with equal counts.
@pytest.mark.parametrize("case", ["dense", "sparse", "one path"])
def test_run_scan_wraps_like_reference(case):
    rng = np.random.default_rng(len(case))
    r = 2 * BLOCK
    if case == "one path":
        run_path = np.zeros(r, np.int32)
        run_count = np.full(r, 2**17 + 3, np.int32)
        mask = np.zeros(128, np.int32)
        mask[0] = 1
    else:
        run_path = rng.integers(0, 100, r).astype(np.int32)
        run_count = rng.integers(2**18, 2**20, r).astype(np.int32)
        mask = padded_mask(100, 5)
        if case == "sparse":
            mask[:100] &= rng.random(100) < 0.2
    ref = ref_run_cumsums(
        jnp.asarray(run_path), jnp.asarray(run_count), jnp.asarray(mask),
        interpret=True,
    )
    port = runscan.masked_run_cumsums(t(run_path), t(run_count), t(mask))
    for a, b in zip(ref, port):
        assert_equal(a, b)
    wide = np.cumsum(np.where(mask[run_path] > 0, run_count, 0).astype(np.int64))
    assert wide[-1] >= 2**31  # the weighted sum wraps
    assert np.array_equal(port[0].numpy(), wide.astype(np.int32))


def test_seg_scan_refuses_a_negative_head_carry():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="head_carry"):
        segscan.masked_depth_cumsums(z, z, z, head_carry=-1)


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_run_scan_matches_reference(case):
    dg = build_graph(parse_gfa_file(str(GRAPH_DIR / case)), "cpu")
    rng = np.random.default_rng(11)
    for _ in range(2):
        mask = np.zeros(-(-(dg.num_paths + 1) // 128) * 128, np.int32)
        mask[: dg.num_paths] = rng.integers(0, 2, dg.num_paths)
        ref = ref_run_cumsums(
            jnp.asarray(dg.run_path.numpy()), jnp.asarray(dg.run_count.numpy()),
            jnp.asarray(mask), interpret=True,
        )
        port = runscan.masked_run_cumsums(dg.run_path, dg.run_count, t(mask))
        for a, b in zip(ref, port):
            assert_equal(a, b)


def planned_reference(csum, bounds, s_pad):
    plan = ref_gatherb.plan_boundary(bounds, s_pad)
    return plan, ref_gatherb.boundary_diff_planned(
        jnp.asarray(csum), jnp.asarray(plan.row_start), jnp.asarray(plan.loc),
        plan.over_tiles, jnp.asarray(plan.over_bounds), w_rows=plan.w_rows,
        n_bounds=bounds.shape[0], interpret=True,
    )


def test_boundary_matches_planned_reference_with_overflow_tiles():
    """Tiles of the reference's plan that overflow its window, and a
    last bound equal to the cumsum's length."""
    rng = np.random.default_rng(5)
    s_pad = 1 << 17
    bounds = np.unique(np.concatenate([
        np.arange(0, 2000, dtype=np.int32),
        np.array([s_pad - 130], np.int32),
        np.arange(s_pad - 128, s_pad + 1, dtype=np.int32),
    ]))
    assert bounds[-1] == s_pad
    csums = [np.cumsum(rng.integers(0, 3, s_pad)).astype(np.int32) for _ in range(2)]
    refs = []
    for c in csums:
        plan, ref = planned_reference(c, bounds, s_pad)
        assert plan.over_tiles
        refs.append(ref)
    for ref, port in zip(refs, gatherb.gather_boundary_diff([t(c) for c in csums], t(bounds))):
        assert_equal(ref, port)
    (one,) = gatherb.gather_boundary_diff([t(csums[0])], t(bounds))
    assert_equal(refs[0], one)


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_boundary_matches_planned_reference_on_fixtures(case):
    dg = build_graph(parse_gfa_file(str(GRAPH_DIR / case)), "cpu")
    rng = np.random.default_rng(31)
    for bounds, length in (
        (dg.seg_bounds, dg.padded_steps),
        (dg.run_seg_bounds, dg.run_path.shape[0]),
    ):
        c = np.cumsum(rng.integers(0, 3, length)).astype(np.int32)
        _, ref = planned_reference(c, bounds.numpy(), length)
        assert_equal(ref, gatherb.gather_boundary_diff([t(c)], bounds)[0])


def fields_of(ref_dg):
    return {f.name: getattr(ref_dg, f.name) for f in dataclasses.fields(ref_dg)}


def extended_mask(mask, p):
    out = np.zeros(-(-(p + 1) // 128) * 128, np.int32)
    out[:p] = mask
    return jnp.asarray(out)


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_scan_and_runs_routes_match_reference_kernels(case):
    """seg_depth_with_uniq_fused / _runs_fused against the reference's
    cumsum kernels (interpret mode) and its boundary stage, on the
    port's own ingest and on the reference's host ingest carried over."""
    g = parse_gfa_file(str(GRAPH_DIR / case))
    ref_dg = build_device_graph(g, device="host")
    rng = np.random.default_rng(3)
    for dg in (build_graph(g, "cpu"), from_host_arrays(fields_of(ref_dg), "cpu")):
        for _ in range(2):
            mask = rng.random(g.num_paths) < 0.5
            mj = extended_mask(mask, g.num_paths)
            want_scan = ref_from_cumsums(
                *ref_depth_cumsums(
                    jnp.asarray(ref_dg.step_path_sorted), jnp.asarray(ref_dg.run_start),
                    mj, interpret=True,
                ),
                jnp.asarray(ref_dg.seg_bounds),
            )
            cswc, csw = ref_run_cumsums(
                jnp.asarray(ref_dg.run_path), jnp.asarray(ref_dg.run_count), mj,
                interpret=True,
            )
            rsb = jnp.asarray(ref_dg.run_seg_bounds)
            want_runs = (ref_boundary_diff(cswc, rsb), ref_boundary_diff(csw, rsb))
            mt = t(mask)
            for plain in (False, True):
                got_scan = port_depth.seg_depth_with_uniq_fused(dg, mt, plain=plain)
                got_runs = port_depth.seg_depth_with_uniq_runs_fused(dg, mt, plain=plain)
                for want, got in ((want_scan, got_scan), (want_runs, got_runs)):
                    for a, b in zip(want, got):
                        assert_equal(a, b)


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_scan_goldens_through_cli(case, monkeypatch):
    """With the ELL and crossing-matrix indexes budgeted away, ``-s``
    routes "scan" and ``-S`` routes "runs"; both print the goldens."""
    monkeypatch.setenv("POLLEN_CROSS_BUDGET_MB", "0")
    stem = case[: -len(".gfa")]
    gfa = str(GRAPH_DIR / case)
    dg = build_graph(parse_gfa_file(gfa), "cpu")
    assert port_depth._best_masked_impl(dg) == "scan"
    assert port_depth.batch_route(dg) == "runs"
    subset = GOLDEN_DIR / f"{stem}.depthpaths"
    want = (GOLDEN_DIR / f"{stem}.depth_subset").read_text()
    assert run_cli(["--device", "cpu", "-I", gfa, "depth", "-d", "-s", str(subset)]) == want


def test_scan_batch_goldens_through_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("POLLEN_CROSS_BUDGET_MB", "0")
    for case in FIXTURE_GRAPHS:
        stem = case[: -len(".gfa")]
        gfa = str(GRAPH_DIR / case)
        names = [b.decode() for b in parse_gfa_file(gfa).path_names()]
        subset = (GOLDEN_DIR / f"{stem}.depthpaths").read_text().split()
        batch = tmp_path / f"{stem}.batch"
        batch.write_text(",".join(subset) + "\n" + " ".join(names) + "\n")
        want = (
            "##query\t0\n" + (GOLDEN_DIR / f"{stem}.depth_subset").read_text()
            + "##query\t1\n" + (GOLDEN_DIR / f"{stem}.depth").read_text()
        )
        assert run_cli(
            ["--device", "cpu", "-I", gfa, "depth", "-d", "-S", str(batch)]
        ) == want, case


def test_wide_graph_routes_scan_and_matches_reference():
    """P = 2^16 + 5 paths: no ELL index (P >= 2^16), and the crossing
    matrix is past the budget, so the router picks "scan"."""
    g = synth_graph(2**18, 2**14, 2**16 + 5)
    dg = build_graph(g, "cpu")
    ref_dg = build_device_graph(g, device="host")
    assert not dg.cross_ell.numel() and not dg.cross_matrix.numel()
    assert port_depth._best_masked_impl(dg) == "scan"
    assert port_depth.batch_route(dg) == "runs"
    rng = np.random.default_rng(8)
    masks = np.stack([rng.random(g.num_paths) < f for f in (0.5, 0.1, 1.0)])
    for m in masks:
        want = ref_depth.seg_depth_with_uniq_masked(ref_dg, jnp.asarray(m))
        got = port_depth.masked_seg_depth(dg, t(m))
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), b)
    d, u = port_depth.seg_depth_with_uniq_batch(dg, t(masks))
    for i, m in enumerate(masks):
        want = ref_depth.seg_depth_with_uniq_runs(ref_dg, jnp.asarray(m))
        assert np.array_equal(np.asarray(want[0]), d[i])
        assert np.array_equal(np.asarray(want[1]), u[i])
