"""The port's sharded queries (pollen_tpu_torch/parallel/sharded.py)
against the reference's on its 8 virtual CPU devices and against the
port's single-device queries: the counterparts of tests/test_parallel.py
and of test_ops_depth.py::test_three_tier_sharded_exact.

The port runs as a real job: one spawned job of 8 gloo ranks on the CPU,
a ``(host, chip) = (2, 4)`` mesh as in the reference's tests, computes
every case on every rank (tests/torch_rank_jobs.py) and the cases below
read its results. Replicated outputs must agree on every rank; sharded
outputs are joined in rank order. Inputs, seeds and parameters are the
reference tests'; every comparison is exact (int32 equality).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_jobs
from conftest import FIXTURE_GRAPHS, GRAPH_DIR
from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import GraphArrays as RefGraphArrays
from pollen_tpu.flatgfa import parse_gfa as ref_parse_gfa
from pollen_tpu.flatgfa import parse_gfa_file as ref_parse_gfa_file
from pollen_tpu.kernels import ellscan as ref_ellscan
from pollen_tpu.kernels.segscan import BLOCK
from pollen_tpu.kernels.segscan import masked_depth_cumsums as ref_depth_cumsums
from pollen_tpu.ops import depth as ref_depth
from pollen_tpu.parallel import make_mesh as ref_make_mesh
from pollen_tpu.parallel import sharded as ref_sh
from pollen_tpu_torch import flatgfa as port_flatgfa
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.kernels import ellscan as port_ellscan
from pollen_tpu_torch.kernels import segscan as port_segscan
from pollen_tpu_torch.ops import depth as port_depth
from pollen_tpu_torch.ops.degree import seg_degree as port_seg_degree
from pollen_tpu_torch.parallel import launch
from pollen_tpu_torch.parallel import sharded as port_sh
from pollen_tpu_torch.synth import synth_graph
from test_torch_depth import three_tier_graph

torch.set_num_threads(1)

RANKS = 8
JOB_DEADLINE = 240  # seconds; the job takes about 10 on one core a rank
STRADDLE_GFA = (
    "H\tVN:Z:1.0\nS\t1\tACGT\nS\t2\tT\nP\tbig\t"
    + ",".join(["1+"] * 64)
    + "\t*\nP\tb2\t2+,1+\t*\n"
)


def heavy_sidecar_gfa() -> str:
    # Segment 1 gets 40 single-crossing runs (heavy for small K) plus a
    # count-21 run (clip residual).
    lines = ["S\t1\tAA"] + [f"S\t{i}\tC" for i in range(2, 40)]
    lines += ["P\tp0\t" + ",".join(["1+"] * 20) + ",2+\t*"]
    lines += [f"P\tp{j}\t1+,{2 + (j % 38)}+\t*" for j in range(1, 40)]
    return "\n".join(lines) + "\n"


OVERFLOW_GFA = "S\t1\tA\nS\t2\tC\nP\tp\t" + ",".join(["1+"] * 300 + ["2+"] * 2) + "\t*\n"


def residual_wrap_arrays() -> dict:
    """test_parallel.py's residual-wrap graph: path 0 crosses segment 600
    twenty times (past the nibble clip: a residual column owned by a
    later rank) and segment 0 once; three more paths cross segment 0."""
    n_segs, n_paths = 1024, 4
    segs = np.array([600] * 20 + [0, 0, 0, 0], np.uint32)
    sb = np.arange(n_segs + 1, dtype=np.uint32)
    return dict(
        header=np.zeros(0, np.uint8),
        seg_name=np.arange(1, n_segs + 1, dtype=np.int64),
        seg_seq=np.stack([sb[:-1], sb[1:]], axis=1),
        seg_optional=np.zeros((n_segs, 2), np.uint32),
        path_name=np.zeros((n_paths, 2), np.uint32),
        path_steps=np.array([[0, 21], [21, 22], [22, 23], [23, 24]], np.uint32),
        path_overlaps=np.zeros((n_paths, 2), np.uint32),
        link_from=np.zeros(0, np.uint32),
        link_to=np.zeros(0, np.uint32),
        steps=segs << np.uint32(1),
        link_overlap=np.zeros((0, 2), np.uint32),
        seq_data=np.zeros(int(sb[-1]), np.uint8),
        overlaps=np.zeros((0, 2), np.uint32),
        alignment=np.zeros(0, np.uint32),
        name_data=np.zeros(0, np.uint8),
        optional_data=np.zeros(0, np.uint8),
        line_order=np.zeros(0, np.uint8),
    )


def to_port(g):
    """A reference (or port) arena as the port's GraphArrays: the ranks
    must unpickle nothing of the reference."""
    return port_flatgfa.GraphArrays(
        **{f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
    )


def ext(bits) -> np.ndarray:
    """int32 [P + 1] mask, the padding sentinel's entry 0."""
    return np.concatenate([np.asarray(bits, np.int32), [0]]).astype(np.int32)


def every_other(p) -> np.ndarray:
    m = np.zeros(p + 1, np.int32)
    m[0:p:2] = 1
    return m


def seeded_bools(seed, p, n=2) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2, p).astype(bool) for _ in range(n)]


def fused_mask() -> np.ndarray:
    rng = np.random.default_rng(11)
    mask = np.zeros(25, np.int32)
    mask[:24] = rng.integers(0, 2, 24)
    return mask


def batch_masks() -> np.ndarray:
    return np.random.default_rng(53).integers(0, 2, (4, 48)).astype(np.int32)


def three_tier_bools() -> np.ndarray:
    return np.random.default_rng(43).integers(0, 2, 64).astype(bool)


def job_cases() -> dict:
    cases = {}
    for name in FIXTURE_GRAPHS:
        g = port_flatgfa.parse_gfa_file(str(GRAPH_DIR / name))
        p = g.num_paths
        full = ext(np.ones(p))
        cases[name] = dict(arena=g, masks={
            "seg": [full, every_other(p)], "scatter": [full],
            "fused": [full, every_other(p)], "degree": True,
        })
        cases[name + ":always"] = dict(
            arena=g, build={"cross_matrix": "always"},
            masks={"cross": [b.astype(np.int32) for b in seeded_bools(23, p)],
                   "ell": [b.astype(np.int32) for b in seeded_bools(29, p)]},
        )
    cases["straddle"] = dict(
        arena=port_flatgfa.parse_gfa(STRADDLE_GFA.encode()),
        masks={"seg": [ext([1, 1])], "fused": [ext([1, 1])]},
    )
    cases["heavy_sidecar"] = dict(
        arena=port_flatgfa.parse_gfa(heavy_sidecar_gfa().encode()),
        build={"cross_matrix": "always"}, masks={"ell": [np.ones(40, np.int32)]},
    )
    cases["cross_overflow"] = dict(
        arena=port_flatgfa.parse_gfa(OVERFLOW_GFA.encode()),
        build={"cross_matrix": "always"}, masks={"cross": [np.ones(1, np.int32)]},
    )
    cases["fused"] = dict(
        arena=synth_graph(4 * BLOCK, 200, 24), block=BLOCK,
        masks={"fused": [fused_mask()], "seg": [fused_mask()]},
    )
    cases["residual_wrap"] = dict(
        arena=port_flatgfa.GraphArrays(**residual_wrap_arrays()),
        masks={"cross": [np.ones(4, np.int32)]},
    )
    cases["ell_batch"] = dict(
        arena=synth_graph(2**14, 2**10, 48), masks={"ell_batch": [batch_masks()]},
    )
    cases["three_tier"] = dict(
        arena=to_port(three_tier_graph()),
        ellscan={"C_TIER_FIXED": 0.0, "C_COL_B": 0.0},
        masks={"ell": [three_tier_bools().astype(np.int32)]},
    )
    return cases


@pytest.fixture(scope="module")
def job():
    """The one spawned job of this module: every case on 8 gloo ranks."""
    return launch.run(
        torch_rank_jobs.parallel_cases, RANKS, job_cases(), device="cpu",
        deadline=JOB_DEADLINE, threads=1,
    )


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"
    return ref_make_mesh()


def replicated(job, key, query, i=0):
    """A replicated output: the same on every rank; rank 0's copy."""
    outs = [r["cases"][key][query][i] for r in job]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            np.testing.assert_array_equal(a, b)
    return outs[0]


def joined(job, key, query, i=0):
    """A sharded output: every rank's slices joined in rank order."""
    outs = [r["cases"][key][query][i] for r in job]
    return [np.concatenate(parts, axis=-1) for parts in zip(*outs)]


def assert_equal(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def port_dg(case, **build):
    return build_graph(port_flatgfa.parse_gfa_file(str(GRAPH_DIR / case)), "cpu", **build)


def test_mesh_shape(job):
    for rank, r in enumerate(job):
        assert r["mesh"] == ((2, 4), ("host", "chip"))
        assert r["index"] == rank  # global rank = host * chips + chip


def test_ranks_load_no_jax_nor_reference(job):
    assert [r["foreign_modules"] for r in job] == [[]] * RANKS


@pytest.mark.parametrize("case", FIXTURE_GRAPHS + ["fused"])
def test_shard_layout_matches_reference(case, job, mesh):
    """Each rank's chunk, joined in rank order, is the reference's
    sharded layout; chunk, chunk starts and counts are the reference's."""
    if case == "fused":
        import bench

        _, dg = bench.synth_device_graph(4 * BLOCK, 200, 24)
        sg = ref_sh.shard_device_graph(dg, mesh, block=BLOCK)
    else:
        dg = build_device_graph(ref_parse_gfa_file(str(GRAPH_DIR / case)))
        sg = ref_sh.shard_device_graph(dg, mesh)
    layouts = [r["cases"][case]["layout"] for r in job]
    for name in ("step_path_sorted", "run_start"):
        assert_equal(np.concatenate([lay[name] for lay in layouts]), getattr(sg, name))
    for lay in layouts:
        for name in ("seg_bounds", "chunk_starts"):
            assert_equal(lay[name], getattr(sg, name))
        for name in ("num_segments", "num_paths", "num_steps", "chunk"):
            assert lay[name] == getattr(sg, name), name
    assert [lay["index"] for lay in layouts] == list(range(RANKS))


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_sharded_depth_matches_single(case, job, mesh):
    dg = build_device_graph(ref_parse_gfa_file(str(GRAPH_DIR / case)))
    sg = ref_sh.shard_device_graph(dg, mesh)
    ref = ref_sh.sharded_seg_depth_fn(mesh)(sg, ref_sh.full_mask(dg.num_paths))
    single = port_depth.seg_depth_with_uniq(port_dg(case))
    for got, want, one in zip(replicated(job, case, "seg", 0), ref, single):
        assert_equal(got, want, one)


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_sharded_depth_masked_matches_single(case, job, mesh):
    dg = build_device_graph(ref_parse_gfa_file(str(GRAPH_DIR / case)))
    sg = ref_sh.shard_device_graph(dg, mesh)
    mask = every_other(dg.num_paths)
    ref = ref_sh.sharded_seg_depth_fn(mesh)(sg, jnp.asarray(mask))
    single = port_depth.seg_depth_with_uniq_masked(
        port_dg(case), torch.from_numpy(mask[:-1].astype(bool))
    )
    for got, want, one in zip(replicated(job, case, "seg", 1), ref, single):
        assert_equal(got, want, one)


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
@pytest.mark.parametrize("which", [0, 1], ids=["all_paths", "every_other"])
def test_sharded_fused_on_fixtures(case, which, job):
    """The fused form (K6's plain version on each rank, with the tensor
    carry) equals the cumsum form and the single-device query."""
    p = port_flatgfa.parse_gfa_file(str(GRAPH_DIR / case)).num_paths
    mask = [ext(np.ones(p)), every_other(p)][which]
    single = port_depth.seg_depth_with_uniq_masked(
        port_dg(case), torch.from_numpy(mask[:-1].astype(bool))
    )
    fused = replicated(job, case, "fused", which)
    for got, want, one in zip(fused, replicated(job, case, "seg", which), single):
        assert_equal(got, want, one)


def test_sharded_uniq_straddling_groups(job, mesh):
    """One segment crossed 64 times by one path: its group spans several
    chunks, and uniq must still be 1."""
    dg = build_device_graph(ref_parse_gfa(STRADDLE_GFA.encode()))
    sg = ref_sh.shard_device_graph(dg, mesh)
    ref = ref_sh.sharded_seg_depth_fn(mesh)(sg, ref_sh.full_mask(dg.num_paths))
    for query in ("seg", "fused"):
        depth, uniq = replicated(job, "straddle", query)
        assert depth.tolist() == [65, 1]
        assert uniq.tolist() == [2, 1]
        assert_equal(depth, ref[0])
        assert_equal(uniq, ref[1])


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_sharded_degree_matches_single(case, job, mesh):
    dg = build_device_graph(ref_parse_gfa_file(str(GRAPH_DIR / case)))
    ref = ref_sh.sharded_degree_fn(mesh)(*ref_sh.shard_degree_inputs(dg, mesh))
    got = [r["cases"][case]["degree"] for r in job]
    for g in got:
        assert_equal(g, ref, port_seg_degree(port_dg(case)))


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_sharded_depth_scatter_output(case, job, mesh):
    """Output-sharded depth (reduce-scatter over the chip group) joins,
    per host row in chip order, to the reference's scattered array and
    to the replicated-output query."""
    dg = build_device_graph(ref_parse_gfa_file(str(GRAPH_DIR / case)))
    sg = ref_sh.shard_device_graph(dg, mesh)
    ref = ref_sh.sharded_seg_depth_scatter_fn(mesh)(sg, ref_sh.full_mask(dg.num_paths))
    outs = [r["cases"][case]["scatter"][0] for r in job]
    n = dg.num_segments
    for host in range(2):
        row = outs[4 * host : 4 * host + 4]
        for k in range(2):
            whole = np.concatenate([o[k] for o in row])
            assert_equal(whole, np.asarray(ref[k]).reshape(-1))
            assert_equal(whole[:n], replicated(job, case, "seg", 0)[k])


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_sharded_cross_depth_matches_single(case, job, mesh):
    """Column-sharded crossing matrix (K2's plain version a rank, no
    collective) vs the reference's and the single-device query,
    including the overflow fix-up."""
    dg = build_device_graph(ref_parse_gfa_file(str(GRAPH_DIR / case)), cross_matrix="always")
    sc = ref_sh.shard_cross_inputs(dg, mesh)
    query = ref_sh.sharded_cross_depth_fn(mesh, nibble=sc.nibble)
    key = case + ":always"
    assert job[0]["cases"][key]["cross_width"] == sc.col_width
    for i, bools in enumerate(seeded_bools(23, dg.num_paths)):
        m = jnp.zeros(sc.num_paths_padded, jnp.int32).at[: dg.num_paths].set(
            jnp.asarray(bools.astype(np.int32))
        )
        ref = query(sc.cross, sc.res, sc.res_seg, m)
        single = port_depth.seg_depth_with_uniq_masked(
            port_dg(case, cross_matrix="always"), torch.from_numpy(bools)
        )
        for got, want, one in zip(joined(job, key, "cross", i), ref, single):
            assert_equal(got, want)
            assert_equal(got[: dg.num_segments], one)


def ref_ell_natural(dg, se, mesh, bools):
    """The reference's sharded tiered ELL query, in natural order."""
    has = dict(has_mid=se.ell2 is not None, has_mid2=se.ell3 is not None,
               has_heavy=se.heavy is not None)
    args = [se.ell] + [t for t in (se.ell2, se.ell3) if t is not None]
    if se.heavy is not None:
        args += [se.heavy, se.heavy_res, se.heavy_res_col]
    parts = ref_sh.sharded_ell_depth_fn(mesh, **has)(
        *args, jnp.asarray(bools.astype(np.int32))
    )
    return parts, ref_sh.compose_ell_parts_natural(dg, parts, **has)


def check_ell(job, key, i, ref_dg, mesh, bools, port_graph):
    """Port parts joined vs the reference's parts; natural order (the
    port's compose) vs the reference's and the single-device query."""
    se = ref_sh.shard_ell_inputs(ref_dg, mesh)
    has_mid, has_mid2, has_heavy = job[0]["cases"][key]["ell_has"]
    assert (has_mid, has_mid2, has_heavy) == (
        se.ell2 is not None, se.ell3 is not None, se.heavy is not None
    )
    ref_parts, (d_ref, u_ref) = ref_ell_natural(ref_dg, se, mesh, bools)
    parts = joined(job, key, "ell", i)
    for got, want in zip(parts, ref_parts):
        assert_equal(got, want)
    d_nat, u_nat = port_sh.compose_ell_parts_natural(
        port_graph, parts, has_mid=has_mid, has_heavy=has_heavy, has_mid2=has_mid2
    )
    d_1, u_1 = port_depth.seg_depth_with_uniq_masked(port_graph, torch.from_numpy(bools))
    assert_equal(d_nat, d_ref, d_1)
    assert_equal(u_nat, u_ref, u_1)


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_sharded_ell_depth_matches_single(case, job, mesh):
    """Column-sharded tiered ELL (K9's and K2's plain versions a rank, no
    collective) vs the reference's and the single-device query."""
    dg = build_device_graph(ref_parse_gfa_file(str(GRAPH_DIR / case)), cross_matrix="always")
    port_graph = port_dg(case, cross_matrix="always")
    for i, bools in enumerate(seeded_bools(29, dg.num_paths)):
        check_ell(job, case + ":always", i, dg, mesh, bools, port_graph)


def test_sharded_ell_heavy_sidecar(job, mesh):
    """Heavy segments' nibble columns and clip residual land on the right
    rank's slice and reconstruct exactly."""
    text = heavy_sidecar_gfa().encode()
    dg = build_device_graph(ref_parse_gfa(text), cross_matrix="always")
    assert dg.ell_heavy_res_col.size
    port_graph = build_graph(port_flatgfa.parse_gfa(text), "cpu", cross_matrix="always")
    assert job[0]["cases"]["heavy_sidecar"]["ell_has"][2]
    check_ell(job, "heavy_sidecar", 0, dg, mesh, np.ones(dg.num_paths, bool), port_graph)


def test_sharded_cross_overflow(job, mesh):
    """Clipped residuals land on the right rank's slice."""
    dg = build_device_graph(ref_parse_gfa(OVERFLOW_GFA.encode()), cross_matrix="always")
    assert dg.cross_res_seg.size
    sc = ref_sh.shard_cross_inputs(dg, mesh)
    m = jnp.zeros(sc.num_paths_padded, jnp.int32).at[:1].set(1)
    ref = ref_sh.sharded_cross_depth_fn(mesh, nibble=sc.nibble)(sc.cross, sc.res, sc.res_seg, m)
    d_c, u_c = joined(job, "cross_overflow", "cross")
    assert d_c[:2].tolist() == [300, 2]
    assert u_c[:2].tolist() == [1, 1]
    assert_equal(d_c, ref[0])
    assert_equal(u_c, ref[1])


def test_sharded_fused_scan_matches_single(job, mesh):
    """The fused form on each rank (K6's plain version with the device
    carry) equals the reference's fused query (its Pallas kernel in
    interpret mode), the cumsum form and the single-device query, on a
    graph whose (segment, path) groups straddle chunk bounds."""
    import bench

    _, dg = bench.synth_device_graph(4 * BLOCK, 200, 24)
    sg = ref_sh.shard_device_graph(dg, mesh, block=BLOCK)
    rs = np.asarray(sg.run_start)
    assert any(rs[sg.chunk * d] < sg.chunk * d for d in range(1, RANKS)), "no straddle"
    mask = fused_mask()
    ref = ref_sh.sharded_seg_depth_fused_fn(mesh, interpret=True)(sg, jnp.asarray(mask))
    single = port_depth.seg_depth_with_uniq_masked(
        build_graph(synth_graph(4 * BLOCK, 200, 24), "cpu"),
        torch.from_numpy(mask[:-1].astype(bool)),
    )
    cumsum = replicated(job, "fused", "seg")
    for got, want, one, xla in zip(replicated(job, "fused", "fused"), ref, single, cumsum):
        assert_equal(got, want, one, xla)


@pytest.mark.parametrize("carry", ["int", "tensor"])
def test_head_carry_kernel_semantics(carry):
    """K6's plain version with head_carry (an int, or the 0-dim int32
    tensor the fused query passes): the first-selected flag of a
    left-straddling group must not fire when the carry says selected
    steps already occurred to the left; equal to the reference's
    kernel in interpret mode."""
    path = np.full(BLOCK, 3, np.int32)
    rs = np.full(BLOCK, -5, np.int32)  # group began 5 positions left
    mask = np.zeros(128, np.int32)
    mask[3] = 1
    for hc, last in ((0, 1), (2, 0)):
        hc_arg = torch.tensor(hc, dtype=torch.int32) if carry == "tensor" else hc
        got = port_segscan.masked_depth_cumsums(
            torch.from_numpy(path), torch.from_numpy(rs), torch.from_numpy(mask), hc_arg
        )
        want = ref_depth_cumsums(
            jnp.asarray(path), jnp.asarray(rs), jnp.asarray(mask),
            interpret=True, head_carry=jnp.int32(hc),
        )
        assert int(got[1][-1]) == last  # carry 0: this chunk holds the first
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            assert_equal(g.numpy(), w)


def test_sharded_residual_wrap_regression(job, mesh):
    """Clip-overflow residual columns owned by a LATER rank must not
    wrap into an earlier rank's columns (the reference remaps them past
    the end; the port masks them out)."""
    dg = build_device_graph(RefGraphArrays(**residual_wrap_arrays()))
    assert np.asarray(dg.cross_res_seg)[0] == 600  # overflow col exists
    sc = ref_sh.shard_cross_inputs(dg, mesh)
    assert sc is not None and 600 // sc.col_width > 0
    assert job[0]["cases"]["residual_wrap"]["cross_width"] == sc.col_width
    mask = jnp.ones(sc.num_paths_padded, jnp.int32).at[4:].set(0)
    ref = ref_sh.sharded_cross_depth_fn(mesh, nibble=sc.nibble)(sc.cross, sc.res, sc.res_seg, mask)
    single = ref_depth.seg_depth_with_uniq_masked(dg, jnp.ones(4, bool))
    port_single = port_depth.seg_depth_with_uniq_masked(
        build_graph(port_flatgfa.GraphArrays(**residual_wrap_arrays()), "cpu"),
        torch.ones(4, dtype=torch.bool),
    )
    for got, want, one, port_one in zip(joined(job, "residual_wrap", "cross"), ref, single, port_single):
        assert_equal(got, want)
        assert_equal(got[:1024], one, port_one)


def test_sharded_ell_batch_matches_single(job, mesh):
    """Job-wide batched tiered ELL (plain batched tiers, K5's plain
    version on the heavy slice) equals the reference's and Q
    single-device masked queries, per class and in natural order."""
    import bench

    _, dg = bench.synth_device_graph(2**14, 2**10, 48)
    se = ref_sh.shard_ell_inputs(dg, mesh)
    assert se is not None and se.heavy is not None
    masks = batch_masks()
    has = dict(has_mid=se.ell2 is not None, has_mid2=se.ell3 is not None, has_heavy=True)
    args = [se.ell] + [t for t in (se.ell2, se.ell3) if t is not None]
    args += [se.heavy, se.heavy_res, se.heavy_res_col, jnp.asarray(masks)]
    ref_parts = ref_sh.sharded_ell_depth_batch_fn(mesh, **has)(*args)
    parts = joined(job, "ell_batch", "ell_batch")
    assert job[0]["cases"]["ell_batch"]["ell_batch_has"] == (
        has["has_mid"], has["has_mid2"], True
    )
    for got, want in zip(parts, ref_parts):
        assert_equal(got, want)
    port_graph = build_graph(synth_graph(2**14, 2**10, 48), "cpu")
    for q in range(masks.shape[0]):
        d_nat, u_nat = port_sh.compose_ell_parts_natural(port_graph, [p[q] for p in parts], **has)
        d_1, u_1 = port_depth.seg_depth_with_uniq_masked(
            port_graph, torch.from_numpy(masks[q].astype(bool))
        )
        d_r, u_r = ref_depth.seg_depth_with_uniq_masked(dg, jnp.asarray(masks[q].astype(bool)))
        assert_equal(d_nat, d_1, d_r)
        assert_equal(u_nat, u_1, u_r)


def test_three_tier_sharded_exact(job, mesh, monkeypatch):
    """Sharded tiered ELL with a live third tier equals the reference's
    sharded query and the single-device query (the counterpart of
    test_ops_depth.py::test_three_tier_sharded_exact)."""
    for mod in (ref_ellscan, port_ellscan):
        monkeypatch.setattr(mod, "C_TIER_FIXED", 0.0)
        monkeypatch.setattr(mod, "C_COL_B", 0.0)
    g = three_tier_graph()
    dg = build_device_graph(g)
    assert job[0]["cases"]["three_tier"]["ell_has"][1]  # a third tier
    check_ell(job, "three_tier", 0, dg, mesh, three_tier_bools(), build_graph(to_port(g), "cpu"))
