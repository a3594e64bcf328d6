"""The flat single-tier ELL (K9) and the reference's fixed-arity split
forms in the port, against the JAX reference on the CPU: ``plan_ell``
and ``build_ell`` on seeded runs and on the fixtures' run indexes,
``masked_ell_depth`` against the Pallas kernel in interpret mode and
its XLA form, the split wrappers against theirs, and the router's
``_cross_beats_scan``. All comparisons are exact (integer counts,
tolerance 0).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXTURE_GRAPHS, GRAPH_DIR
from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import parse_gfa_file
from pollen_tpu.kernels import ellscan as ref
from pollen_tpu.ops import depth as ref_depth
from pollen_tpu_torch.device import from_host_arrays
from pollen_tpu_torch.kernels import ellscan as port
from pollen_tpu_torch.ops import depth as port_depth

torch.set_num_threads(1)


def _runs(seed, n_segs=700, max_path=300, big_count=False):
    """Seeded segment-grouped runs: (path, count, segment) int32, unique
    (segment, path) pairs, Zipf-ish runs per segment."""
    rng = np.random.default_rng(seed)
    per = np.minimum(rng.zipf(1.5, n_segs), 40)
    per[rng.random(n_segs) < 0.1] = 0  # never-crossed segments
    seg = np.repeat(np.arange(n_segs), per).astype(np.int32)
    path = np.concatenate(
        [np.sort(rng.choice(max_path, r, replace=False)) for r in per if r]
    ).astype(np.int32)
    count = rng.integers(1, 30, seg.size).astype(np.int32)
    if big_count:
        count[rng.integers(0, seg.size, 3)] = 70000
    return path, count, seg


def _fixture_runs(name):
    """The real runs of a fixture's reference host ingest (padding runs
    left out) and its segment count."""
    dg = build_device_graph(parse_gfa_file(str(GRAPH_DIR / name)), device="host")
    rsb = np.asarray(dg.run_seg_bounds)
    r = int(rsb[-1])
    seg = np.repeat(np.arange(dg.num_segments), np.diff(rsb)).astype(np.int32)
    return (np.asarray(dg.run_path)[:r], np.asarray(dg.run_count)[:r], seg,
            dg.num_segments, dg.num_paths)


@pytest.mark.parametrize("p_pad", [128, 384, 65536])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_ell_matches_reference(seed, p_pad):
    rng = np.random.default_rng(seed)
    runs = np.minimum(rng.zipf(1.4, 50_000) - 1, 60)
    big = rng.random(50_000) < 0.002
    k_r, heavy_r = ref.plan_ell(runs, big, p_pad)
    k_p, heavy_p = port.plan_ell(runs, big, p_pad)
    assert k_p == k_r
    assert np.array_equal(heavy_p, heavy_r)


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_ell_tiers_matches_reference(seed):
    rng = np.random.default_rng(seed + 10)
    runs = np.minimum(rng.zipf(1.6, 200_000) - 1, 80)
    big = rng.random(200_000) < 0.01
    for p_pad in (128, 384):
        got = port.plan_ell_tiers(runs, big, p_pad)
        want = ref.plan_ell_tiers(runs, big, p_pad)
        assert got[:2] == want[:2]
        for a, b in zip(got[2:], want[2:]):
            assert np.array_equal(a, b)
    # No crossed segment fits: k1 = 1, k2 = 0, everything heavy.
    runs = np.array([0, 50, 60])
    got = port.plan_ell_tiers(runs, np.zeros(3, bool), 128)
    want = ref.plan_ell_tiers(runs, np.zeros(3, bool), 128)
    assert got[:2] == want[:2] == (1, 0)
    assert np.array_equal(got[4], want[4])


@pytest.mark.parametrize("k", [None, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("seed,max_path,big", [
    (0, 300, False), (1, 65536, False), (2, 300, True),
])
def test_build_ell_matches_reference(seed, max_path, big, k):
    """Seeded runs: the planner's K and forced K, path ids up to 65535,
    counts above 65535 making their segments heavy."""
    path, count, seg = _runs(seed, max_path=max_path, big_count=big)
    n = 700
    ell_r, heavy_r = ref.build_ell(path, count, seg, n, k=k)
    ell_p, heavy_p = port.build_ell(path, count, seg, n, k=k)
    assert ell_p.dtype == np.int32 and ell_p.shape == ell_r.shape
    assert np.array_equal(ell_p, ell_r)
    assert heavy_p.dtype == np.int32 and np.array_equal(heavy_p, heavy_r)
    if big:
        over = np.unique(seg[count > port.COUNT_MAX])
        assert over.size and np.isin(over, heavy_p).all()
    assert not ell_p[:, heavy_p].any()  # heavy columns stay empty


@pytest.mark.parametrize("k", [None, 1, 2, 4, 16])
@pytest.mark.parametrize("name", FIXTURE_GRAPHS)
def test_build_ell_on_fixtures(name, k):
    path, count, seg, n, _ = _fixture_runs(name)
    ell_r, heavy_r = ref.build_ell(path, count, seg, n, k=k)
    ell_p, heavy_p = port.build_ell(path, count, seg, n, k=k)
    assert np.array_equal(ell_p, ell_r) and np.array_equal(heavy_p, heavy_r)


def _ell_depth_case(rng, k, n_pad, n_paths):
    path = rng.integers(0, n_paths, (k, n_pad))
    cnt = rng.integers(1, 0x10000, (k, n_pad))
    v = (path << 16) | cnt
    v[rng.random((k, n_pad)) < 0.3] = 0
    ell = (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    mask = rng.integers(0, 2, n_paths).astype(np.int32)
    return ell, mask


@pytest.mark.parametrize("k,n_pad,n_paths", [
    (1, 128, 40), (2, 384, 300), (4, 4096, 96), (8, 640, 1000), (16, 256, 64),
])
def test_masked_ell_depth_matches_pallas_interpret(k, n_pad, n_paths):
    """N_pad a multiple of 128 (not only of the reference's 4096 block),
    K in {1, ..., 16}; the wrapper's CPU path launches no kernel."""
    rng = np.random.default_rng(k * 1000 + n_pad)
    ell, mask = _ell_depth_case(rng, k, n_pad, n_paths)
    d_r, u_r = ref.masked_ell_depth(
        jnp.asarray(ell), jnp.asarray(mask), interpret=True
    )
    d_x, u_x = ref.masked_ell_depth_xla(jnp.asarray(ell), jnp.asarray(mask))
    before = dict(port.launches)
    d_p, u_p = port.masked_ell_depth(torch.from_numpy(ell), torch.from_numpy(mask))
    assert port.launches == before
    assert d_p.dtype == torch.int32 and d_p.shape == (n_pad,)
    for want_d, want_u in ((d_r, u_r), (d_x, u_x)):
        assert np.array_equal(np.asarray(want_d), d_p.numpy())
        assert np.array_equal(np.asarray(want_u), u_p.numpy())


def test_ell_high_path_ids():
    """The reference's case: ids >= 2^15 set the word's sign bit, and
    the reference's build_ell output is carried into the port."""
    paths = np.array([5, 32768, 40000, 65535], np.int32)
    counts = np.array([3, 7, 2, 1], np.int32)
    segs = np.array([0, 0, 1, 2], np.int32)
    ell, heavy = ref.build_ell(paths, counts, segs, num_segments=128, k=2)
    assert heavy.size == 0
    rng = np.random.default_rng(11)
    mask = rng.integers(0, 2, 65536).astype(np.int32)
    mask[paths[:2]] = 1
    want_d = np.zeros(128, np.int64)
    want_u = np.zeros(128, np.int64)
    for p, c, s in zip(paths, counts, segs):
        want_d[s] += mask[p] * c
        want_u[s] += mask[p]
    d_r, u_r = ref.masked_ell_depth(jnp.asarray(ell), jnp.asarray(mask),
                                    interpret=True)
    d_p, u_p = port.masked_ell_depth(torch.from_numpy(ell), torch.from_numpy(mask))
    assert np.array_equal(d_p.numpy(), want_d) and np.array_equal(u_p.numpy(), want_u)
    assert np.array_equal(np.asarray(d_r), d_p.numpy())
    assert np.array_equal(np.asarray(u_r), u_p.numpy())


@pytest.mark.parametrize("name", FIXTURE_GRAPHS)
def test_flat_ell_on_fixtures_matches_runs(name):
    """build_ell then masked_ell_depth equals a sum over the runs on the
    light segments, and 0 on the heavy ones."""
    path, count, seg, n, p = _fixture_runs(name)
    ell, heavy = port.build_ell(path, count, seg, n)
    rng = np.random.default_rng(len(name))
    for _ in range(3):
        mask = rng.random(p) < 0.5
        d, u = port.masked_ell_depth(torch.from_numpy(ell), torch.from_numpy(mask))
        want_d = np.bincount(seg, mask[path] * count, minlength=n)
        want_u = np.bincount(seg, mask[path], minlength=n)
        want_d[heavy] = 0
        want_u[heavy] = 0
        assert np.array_equal(d.numpy()[:n], want_d)
        assert np.array_equal(u.numpy()[:n], want_u)
        assert not d.numpy()[n:].any()


def test_masked_ell_depth_checks_inputs():
    mask = torch.ones(8, dtype=torch.int32)
    ell = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(TypeError):
        port.masked_ell_depth(ell.to(torch.int64), mask)
    with pytest.raises(ValueError, match="multiple of 128"):
        port.masked_ell_depth(ell[:, :200].contiguous(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        port.masked_ell_depth(torch.zeros((256, 2), dtype=torch.int32).t(), mask)
    with pytest.raises(ValueError, match="no kernel"):
        port.masked_ell_depth(ell.to("meta"), mask.to("meta"))


def _tall(rng, k, n_cols, p, pack16):
    path = rng.integers(0, p, (k, n_cols))
    cnt = rng.integers(1, 256 if pack16 else 0x10000, (k, n_cols))
    v = ((path << 16) | cnt).astype(np.int64)
    v[rng.random((k, n_cols)) < 0.3] = 0
    flat = (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    if pack16:
        flat = ref.pair_ell16(flat)
    return ref.pack_ell_tall(flat), flat.shape[0]


@pytest.mark.parametrize("heavy_rows", [0, 64])
def test_split_wrappers_match_reference(heavy_rows):
    """masked_ell_split_depth (one tier) and masked_ell_split3_depth (two
    tiers) against the reference's, in interpret mode."""
    rng = np.random.default_rng(40 + heavy_rows)
    p = 120
    t1, k1 = _tall(rng, 2, 3000, p, False)
    t2, k2 = _tall(rng, 4, 700, p, False)
    heavy = rng.integers(0, 256, (heavy_rows, 256 if heavy_rows else 0))
    heavy = heavy.astype(np.uint8)
    mask = rng.integers(0, 2, p).astype(np.int32)
    j = jnp.asarray
    t = torch.from_numpy
    for outs_r, outs_p in (
        (ref.masked_ell_split_depth(j(t1), j(heavy), j(mask), k1,
                                    interpret=True),
         port.masked_ell_split_depth(t(t1), t(heavy), t(mask), k1)),
        (ref.masked_ell_split3_depth(j(t1), j(t2), j(heavy), j(mask), k1, k2,
                                     interpret=True),
         port.masked_ell_split3_depth(t(t1), t(t2), t(heavy), t(mask), k1, k2)),
    ):
        assert len(outs_p) == len(outs_r)
        for a, b in zip(outs_r, outs_p):
            assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("mid,heavy_rows", [(False, 64), (True, 64), (True, 0)])
def test_split3_batch_wrapper_matches_reference(mid, heavy_rows):
    """Absent classes are None in both."""
    rng = np.random.default_rng(50 + mid + heavy_rows)
    p, q = 120, 5
    t1, k1 = _tall(rng, 1, 3000, p, False)
    t2, k2 = _tall(rng, 4, 700, p, False) if mid else (np.zeros((0, 0), np.int32), 0)
    heavy = rng.integers(0, 256, (heavy_rows, 256 if heavy_rows else 0))
    heavy = heavy.astype(np.uint8)
    masks = rng.integers(0, 2, (q, p)).astype(np.int32)
    j = jnp.asarray
    t = torch.from_numpy
    outs_r = ref.masked_ell_split3_depth_batch(
        j(t1), j(t2), j(heavy), j(masks), k1, k2, interpret=True
    )
    outs_p = port.masked_ell_split3_depth_batch(
        t(t1), t(t2), t(heavy), t(masks), k1, k2
    )
    assert len(outs_p) == len(outs_r) == 6
    for a, b in zip(outs_r, outs_p):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("cross_matrix", ["auto", "always", "never"])
@pytest.mark.parametrize("name", ["tiny.gfa", "rand1.gfa", "rand2.gfa"])
def test_cross_beats_scan_matches_reference(name, cross_matrix):
    dg = build_device_graph(parse_gfa_file(str(GRAPH_DIR / name)), device="host",
                            cross_matrix=cross_matrix)
    fields = {f.name: getattr(dg, f.name) for f in dataclasses.fields(dg)}
    port_dg = from_host_arrays(fields, "cpu")
    assert port_depth._cross_beats_scan(port_dg) == ref_depth._cross_beats_scan(dg)
    # The same graph with its ELL index dropped: the matrix may win.
    no_ell = dataclasses.replace(dg, cross_ell=np.zeros((0, 0), np.int32))
    port_no_ell = dataclasses.replace(port_dg, cross_ell=port_dg.cross_ell[:0])
    assert (port_depth._cross_beats_scan(port_no_ell)
            == ref_depth._cross_beats_scan(no_ell))
