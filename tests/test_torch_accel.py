"""The port's fixed-dimension accelerator (``pollen_tpu_torch/accel``)
against the JAX package on the CPU, exactly: the PE array and its
single-PE form against the reference's jitted functions on every
fixture's memories (also oversized, undersized and out-of-range ones,
where JAX clamps a gather), the depth goldens, the JSON memories, and
``exine-torch --device cpu`` against ``exine-tpu`` text for text.
"""

import contextlib
import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXTURE_GRAPHS, GOLDEN_DIR, GRAPH_DIR
from pollen_tpu.accel import __main__ as ref_main
from pollen_tpu.accel import datagen as ref_datagen
from pollen_tpu.accel import kernel as ref_kernel
from pollen_tpu.flatgfa import parse_gfa_file as ref_parse_gfa_file
from pollen_tpu_torch.accel import __main__ as port_main
from pollen_tpu_torch.accel import datagen
from pollen_tpu_torch.accel.kernel import (
    node_depth_accel,
    node_depth_accel_simple,
    run_accel,
)
from pollen_tpu_torch.flatgfa import parse_gfa_file

torch.set_num_threads(1)


def sequential(g) -> bool:
    return bool(g.num_segments and (
        g.seg_name == np.arange(1, g.num_segments + 1)).all())


def subset_of(stem: str) -> list:
    return [ln for ln in (GOLDEN_DIR / f"{stem}.depthpaths").read_text()
            .splitlines() if ln]


def both_accels(path_ids: np.ndarray, consider: np.ndarray, max_p: int):
    """(port PE array, port single PE, reference PE array), as numpy."""
    ids, cons = torch.from_numpy(path_ids), torch.from_numpy(consider)
    ref = ref_kernel.node_depth_accel(jnp.asarray(path_ids),
                                      jnp.asarray(consider), max_p)
    return [tuple(x.numpy() for x in node_depth_accel(ids, cons, max_p)),
            tuple(x.numpy() for x in node_depth_accel_simple(ids, cons,
                                                             max_p)),
            tuple(np.asarray(x) for x in ref)]


def assert_all_equal(results):
    """The port's answers are int32, as the reference documents; the
    reference's sum is int64 once JAX runs with x64 on (after
    ``pollen_tpu.device`` is imported), so its values are compared."""
    for x in results[0] + results[1]:
        assert x.dtype == np.int32
    for got in results[1:]:
        for x, y in zip(got, results[0]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_memories_and_pe_array_match_reference(case):
    path = str(GRAPH_DIR / case)
    g, g_ref = parse_gfa_file(path), ref_parse_gfa_file(path)
    assert datagen.accel_dims(g) == ref_datagen.accel_dims(g_ref)
    n, e, p = datagen.accel_dims(g)
    for dims, subset in (((n, e, p), None), ((n, e, p), subset_of(case[:-4])),
                         ((n + 3, e + 5, p + 2), None), ((n, e, p + 7),
                                                         subset_of(case[:-4]))):
        text = datagen.depth_json(g, *dims, subset)
        assert text == ref_datagen.depth_json(g_ref, *dims, subset)
        path_ids, consider = datagen.parse_depth_json(text)
        want = ref_datagen.parse_depth_json(text)
        np.testing.assert_array_equal(path_ids, want[0])
        np.testing.assert_array_equal(consider, want[1])
        results = both_accels(path_ids, consider, consider.shape[0] - 1)
        assert_all_equal(results)
        table = datagen.depth_table_from_outputs(*results[0])
        assert table == ref_datagen.depth_table_from_outputs(*results[2])
        if sequential(g) and dims[0] == n:
            golden = "depth_subset" if subset else "depth"
            assert table == (GOLDEN_DIR / f"{case[:-4]}.{golden}").read_text()
    assert datagen.graph_json(g) == ref_datagen.graph_json(g_ref)


def test_oversized_dims_pad_with_zero_rows():
    g = parse_gfa_file(str(GRAPH_DIR / "tiny.gfa"))
    n, e, p = datagen.accel_dims(g)
    path_ids, consider = datagen.parse_depth_json(
        datagen.depth_json(g, max_n=n + 3, max_e=e + 5, max_p=p))
    depth, uniq = run_accel(path_ids, consider, "cpu")
    assert (depth[n:] == 0).all() and (uniq[n:] == 0).all()
    golden = (GOLDEN_DIR / "tiny.depth").read_text().strip().splitlines()
    for i, line in enumerate(golden[1:]):
        _, d, u = line.split("\t")
        assert (depth[i], uniq[i]) == (int(d), int(u))


@pytest.mark.parametrize("seed", range(3))
def test_out_of_range_ids_follow_the_reference_clamp(seed):
    """Ids past P (a ``-p`` smaller than the graph's paths) and negative
    ids: JAX wraps a negative gather index once and clamps the rest;
    the port does the same explicitly, and such ids mark no path."""
    rng = np.random.default_rng(seed)
    max_p = int(rng.integers(1, 12))
    path_ids = rng.integers(-2 * max_p - 3, 2 * max_p + 3,
                            (40, int(rng.integers(1, 9)))).astype(np.int32)
    consider = rng.integers(0, 3, max_p + 1).astype(np.int32)
    assert_all_equal(both_accels(path_ids, consider, max_p))


def test_empty_memories():
    for shape in ((0, 4), (5, 0)):
        assert_all_equal(both_accels(np.zeros(shape, np.int32),
                                     np.ones(4, np.int32), 3))


@pytest.mark.parametrize("case", ["tiny.gfa", "rand1.gfa"])
def test_graph_json_round_trip_matches_reference(case):
    g = parse_gfa_file(str(GRAPH_DIR / case))
    again = datagen.graph_from_json(datagen.graph_json(g))
    want = ref_datagen.graph_from_json(ref_datagen.graph_json(
        ref_parse_gfa_file(str(GRAPH_DIR / case))))
    assert datagen.graph_json(again) == ref_datagen.graph_json(want)


# ---------------------------------------------------------------------------
# exine-torch against exine-tpu
# ---------------------------------------------------------------------------


def ref_exine(argv, monkeypatch) -> str:
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["exine-tpu", *argv])
    with contextlib.redirect_stdout(out):
        ref_main.main()
    return out.getvalue()


def port_exine(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_main.main(["--device", "cpu", *argv])
    return out.getvalue()


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_exine_matches_reference(case, tmp_path, monkeypatch):
    path = str(GRAPH_DIR / case)
    subset = tmp_path / "subset.txt"
    subset.write_text("\n".join(subset_of(case[:-4])) + "\n")
    g = parse_gfa_file(path)
    n, e, p = datagen.accel_dims(g)
    for argv in (
        ["depth", "--gen", path], ["depth", "-a", "-r", path],
        ["depth", "-a", "-s", str(subset), path],
        ["depth", "-n", str(n + 2), "-e", str(e + 1), "-p", str(p), path],
        ["depth", "-n", str(n), path], ["json", path],
    ):
        got = port_exine(argv)
        assert got and got == ref_exine(argv, monkeypatch), argv
    if sequential(g):
        assert port_exine(["depth", "-a", "-r", path]) == (
            GOLDEN_DIR / f"{case[:-4]}.depth").read_text()


def test_exine_errors(capsys, tmp_path):
    """A missing command prints help and exits 1, as the reference does;
    an unknown path in ``-s`` is one error line; ``--device cuda``
    without a card is an error, never a quiet CPU run."""
    with pytest.raises(SystemExit) as exc:
        port_main.main(["--device", "cpu"])
    assert exc.value.code == 1
    subset = tmp_path / "subset.txt"
    subset.write_text("nope\n")
    with pytest.raises(SystemExit) as exc:
        port_main.main(["--device", "cpu", "depth", "-s", str(subset),
                        str(GRAPH_DIR / "tiny.gfa")])
    assert exc.value.code == 1
    assert capsys.readouterr().err.endswith("exine-torch: error: 'nope'\n")
    if torch.cuda.is_available():
        return  # the rest checks a machine with no card
    for argv in (["depth", "-a", "-r"], ["depth", "--gen"], ["json"]):
        with pytest.raises(SystemExit) as exc:
            port_main.main(["--device", "cuda", *argv,
                            str(GRAPH_DIR / "tiny.gfa")])
        assert exc.value.code == 1
        assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        port_main.main(["depth", "-a", "-r", str(GRAPH_DIR / "tiny.gfa")])
