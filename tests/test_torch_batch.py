"""The port's batched subset-depth slice (``depth -S``) against the JAX
reference on the CPU: the per-class batch parts, the routed batch
(ELL, crossing matrix, run index) with ragged Q and Q over the chunk,
the tier-3 fold, the batch's own routing, and ``fgfa-torch depth -S``
and ``serve`` against ``pollen_tpu.cli`` run in-process. States come
from the port's ingest and from the reference's host ingest carried
across (from_host_arrays), under both tier-plan objectives. All
comparisons are exact (integer counts, tolerance 0; text byte for
byte).
"""

import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXTURE_GRAPHS, GOLDEN_DIR, GRAPH_DIR
from pollen_tpu import cli as ref_cli
from pollen_tpu.device import build_device_graph
from pollen_tpu.kernels import ellscan as ref_ellscan
from pollen_tpu.ops import depth as ref_depth
from pollen_tpu_torch.device import build_graph, from_host_arrays
from pollen_tpu_torch.kernels import ellscan as port_ellscan
from pollen_tpu_torch.ops import depth as port_depth
from test_torch_depth import CASES, load_case, run_cli, three_tier_graph

torch.set_num_threads(1)


def batch_masks(p, q, seed):
    """(q, p) bool masks of varied density; row 0 all paths, row 1 none."""
    rng = np.random.default_rng(seed)
    m = rng.random((q, p)) < rng.random((q, 1))
    m[0] = True
    m[1] = False
    return m


def port_graphs(ref_dg, g, **ingest):
    fields = {f.name: getattr(ref_dg, f.name) for f in dataclasses.fields(ref_dg)}
    return {
        "carried": from_host_arrays(fields, "cpu"),
        "built": build_graph(g, "cpu", **ingest),
    }


def assert_parts_equal(ref_parts, port_parts):
    assert len(ref_parts) == len(port_parts) == 6
    for a, b in zip(ref_parts, port_parts):
        assert (a is None) == (b is None)
        if a is not None:
            assert b.dtype == torch.int32
            assert np.array_equal(np.asarray(a), b.numpy())


def assert_batch_equal(ref_dg, dgs, masks):
    d_r, u_r = ref_depth.seg_depth_with_uniq_batch(ref_dg, jnp.asarray(masks))
    for how, dg in dgs.items():
        d_p, u_p = port_depth.seg_depth_with_uniq_batch(
            dg, torch.from_numpy(masks)
        )
        assert d_p.dtype == np.int32 and u_p.dtype == np.int32, how
        assert d_p.shape == (masks.shape[0], dg.num_segments), how
        assert np.array_equal(np.asarray(d_r), d_p), how
        assert np.array_equal(np.asarray(u_r), u_p), how


def check_ell_batch_parts(ref_dg, dgs, masks):
    ref_parts = ref_depth.seg_depth_with_uniq_ell_batch_parts(
        ref_dg, jnp.asarray(masks), pallas=False
    )
    for dg in dgs.values():
        for plain in (True, False):
            assert_parts_equal(
                ref_parts,
                port_depth.seg_depth_with_uniq_ell_batch_parts(
                    dg, torch.from_numpy(masks), plain=plain
                ),
            )


@pytest.mark.parametrize("objective", ["single", "batch"])
@pytest.mark.parametrize("case", CASES)
def test_batch_matches_reference(case, objective):
    """Q = 5 (ragged: the reference pads it to 8) and Q = 40 (over the
    32-query chunk), both port states, the batch parts on "ell"."""
    g = load_case(case)
    ref_dg = build_device_graph(g, device="host", ell_objective=objective)
    dgs = port_graphs(ref_dg, g, ell_objective=objective)
    route = port_depth.batch_route(dgs["built"])
    assert route == port_depth.batch_route(dgs["carried"])
    if route == "ell":
        assert ref_depth._best_masked_impl(ref_dg) == "ell"
        check_ell_batch_parts(ref_dg, dgs, batch_masks(g.num_paths, 5, 2))
    else:
        assert route == "cross" and ref_dg.cross_matrix.size
    if objective == "batch" and ref_dg.cross_ell.size:
        assert ref_dg.ell_pack16 == 0 == dgs["built"].ell_pack16
    for q, seed in ((5, 0), (40, 1)):
        assert_batch_equal(ref_dg, dgs, batch_masks(g.num_paths, q, seed))


def test_three_tier_batch_matches_reference(monkeypatch):
    """Three tiers plus heavy: one launch for every tier, the third
    folded into the mid pair."""
    for mod in (ref_ellscan, port_ellscan):
        monkeypatch.setattr(mod, "C_TIER_FIXED", 0.0)
        monkeypatch.setattr(mod, "C_COL_B", 0.0)
    g = three_tier_graph()
    ref_dg = build_device_graph(g, device="host")
    assert ref_dg.ell_k3 > 0 and ref_dg.ell_num_mid2 > 0
    dgs = port_graphs(ref_dg, g)
    assert port_depth.batch_route(dgs["built"]) == "ell"
    masks = batch_masks(g.num_paths, 5, 3)
    check_ell_batch_parts(ref_dg, dgs, masks)
    assert_batch_equal(ref_dg, dgs, masks)


def test_batch_routes_cross_where_single_query_picks_runs(monkeypatch):
    """With the run index made cheapest, a single query routes "runs";
    a batch takes the resident crossing matrix all the same, and the
    run index only when no matrix is resident."""
    for mod in (ref_depth, port_depth):
        for name in ("_RUNS_EQUIV_BYTES", "_BND_EQUIV_BYTES", "_BND_XLA_EQUIV_BYTES"):
            monkeypatch.setattr(mod, name, 0)
    g = load_case("rand1.gfa")
    masks = batch_masks(g.num_paths, 5, 4)
    ref_dg = build_device_graph(g, device="host")
    dgs = port_graphs(ref_dg, g)
    assert ref_depth._best_masked_impl(ref_dg) == "runs"
    for dg in dgs.values():
        assert port_depth._best_masked_impl(dg) == "runs"
        assert port_depth.batch_route(dg) == "cross"
    assert_batch_equal(ref_dg, dgs, masks)
    ref_dg = build_device_graph(g, device="host", cross_matrix="never")
    dgs = port_graphs(ref_dg, g, cross_matrix="never")
    for dg in dgs.values():
        assert port_depth.batch_route(dg) == "runs"
    assert_batch_equal(ref_dg, dgs, masks)


def run_ref_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref_cli.main(argv)
    return out.getvalue()


def batch_file(tmp_path, g, stem):
    """The golden subset comma-joined, a blank line, all paths
    space-separated, then one path."""
    names = [b.decode() for b in g.path_names()]
    subset = (GOLDEN_DIR / f"{stem}.depthpaths").read_text().split()
    path = tmp_path / f"{stem}.batch"
    path.write_text(
        ",".join(subset) + "\n\n" + " ".join(names) + "\n" + names[-1] + "\n"
    )
    return path


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_depth_S_through_cli_matches_reference(case, tmp_path):
    stem = case[: -len(".gfa")]
    gfa = str(GRAPH_DIR / case)
    g = load_case(case)
    batch = str(batch_file(tmp_path, g, stem))
    for flags in (["-d", "-S", batch], ["-S", batch]):
        got = run_cli(["--device", "cpu", "-I", gfa, "depth", *flags])
        assert got == run_ref_cli(["-I", gfa, "depth", *flags])
    golden = (
        "##query\t0\n" + (GOLDEN_DIR / f"{stem}.depth_subset").read_text()
        + "##query\t1\n" + (GOLDEN_DIR / f"{stem}.depth").read_text()
    )
    assert got.startswith(golden)
    assert got.count("##query\t") == 3


def test_serve_answers_batches(tmp_path):
    gfa = str(GRAPH_DIR / "rand1.gfa")
    batch = str(batch_file(tmp_path, load_case("rand1.gfa"), "rand1"))
    text = run_cli(
        ["--device", "cpu", "-I", gfa, "serve"],
        f"depth -d -S {batch}\ndepth -S {batch}\n",
    )
    want = run_ref_cli(["-I", gfa, "depth", "-d", "-S", batch])
    assert text == (want + "##end\tok\n") * 2
