"""Port ingest (pollen_tpu_torch.device.build_graph) against the JAX
reference's host ingest, field by field; and the port's own copies of
the arena's parser, the binary loader and the CLI grammar against the
reference's.

Every array must be equal (np.array_equal: integer counts and packed
words, tolerance 0) and every static field identical; the boundary plan
and the router's pick must agree too, so the port routes every graph as
the reference does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import FIXTURE_GRAPHS, GRAPH_DIR
from graphgen import big_step_graph, random_graph
from pollen_tpu import cli as ref_cli
from pollen_tpu import fileformat as ref_fileformat
from pollen_tpu import flatgfa as ref_flatgfa
from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import parse_gfa, parse_gfa_file
from pollen_tpu_torch import cli as port_cli
from pollen_tpu_torch import fileformat as port_fileformat
from pollen_tpu_torch import flatgfa as port_flatgfa
from pollen_tpu.kernels import gatherb as ref_gatherb
from pollen_tpu.ops import depth as ref_depth
from pollen_tpu_torch.device import (
    META_FIELDS,
    TENSOR_FIELDS,
    build_graph,
    from_host_arrays,
)
from pollen_tpu_torch.kernels import gatherb
from pollen_tpu_torch.ops import depth as port_depth
from pollen_tpu_torch.synth import synth_graph
from test_torch_ops import port_run, ref_run

torch.set_num_threads(1)

GENERATED = {
    "gen_rand_s0": lambda: random_graph(n_segs=60, n_paths=8, seed=0),
    "gen_rand_s3": lambda: random_graph(n_segs=200, n_paths=24, seed=3),
    "gen_rand_olap": lambda: random_graph(
        n_segs=40, n_paths=5, seed=5, with_overlap_col=True
    ),
    "gen_bigstep": lambda: big_step_graph(300, 6000, 12, seed=2),
}
SYNTH = {
    "synth_p96": (2**16, 2**12, 96),
    "synth_p300": (2**16, 2**12, 300),
}


def load_case(name: str):
    if name in GENERATED:
        return parse_gfa(GENERATED[name]().encode())
    if name in SYNTH:
        return synth_graph(*SYNTH[name])
    return parse_gfa_file(str(GRAPH_DIR / name))


CASES = FIXTURE_GRAPHS + sorted(GENERATED) + sorted(SYNTH)


def assert_same_graph(ref, port):
    for f in TENSOR_FIELDS:
        a = np.asarray(getattr(ref, f))
        b = getattr(port, f).numpy()
        assert a.shape == b.shape, (f, a.shape, b.shape)
        assert np.array_equal(a, b), f
    for f in META_FIELDS:
        assert getattr(ref, f) == getattr(port, f), f
    assert ref.padded_steps == port.padded_steps
    assert ref.num_steps == port.num_steps


@pytest.mark.parametrize("objective", ["single", "batch"])
@pytest.mark.parametrize("case", CASES)
def test_build_graph_matches_reference(case, objective):
    g = load_case(case)
    ref = build_device_graph(g, device="host", ell_objective=objective)
    port = build_graph(g, "cpu", ell_objective=objective)
    assert_same_graph(ref, port)
    assert port_depth._best_masked_impl(port) == ref_depth._best_masked_impl(
        ref
    )
    assert port_depth._masked_impl_costs(port) == (
        ref_depth._masked_impl_costs(ref)
    )


@pytest.mark.parametrize("case", CASES)
def test_plan_boundary_matches_reference(case):
    g = load_case(case)
    port = build_graph(g, "cpu")
    for bounds, length in (
        (port.seg_bounds.numpy(), port.padded_steps),
        (port.run_seg_bounds.numpy(), port.run_path.shape[0]),
    ):
        a = ref_gatherb.plan_boundary(bounds, length)
        b = gatherb.plan_boundary(bounds, length)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert np.array_equal(x, y), f.name
            else:
                assert x == y, f.name


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(minimal=True),
        dict(cross_matrix="never"),
        dict(cross_matrix="always"),
    ],
    ids=["minimal", "cross_never", "cross_always"],
)
def test_build_graph_options_match_reference(kwargs):
    g = synth_graph(2**15, 2**11, 64)
    assert_same_graph(
        build_device_graph(g, device="host", **kwargs),
        build_graph(g, "cpu", **kwargs),
    )


@pytest.mark.parametrize(
    "env",
    [
        {"POLLEN_ELL_PACK16": "0"},
        {"POLLEN_CROSS_BUDGET_MB": "0.05"},
        {"POLLEN_ELL_OBJECTIVE": "batch"},
    ],
    ids=["pack16_off", "small_budget", "objective_env"],
)
def test_build_graph_env_knobs_match_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    g = synth_graph(2**15, 2**11, 64)
    assert_same_graph(
        build_device_graph(g, device="host"), build_graph(g, "cpu")
    )


def test_from_host_arrays_equals_build_graph():
    g = synth_graph(2**15, 2**11, 96)
    ref = build_device_graph(g, device="host")
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    carried = from_host_arrays(fields, "cpu")
    built = build_graph(g, "cpu")
    for f in TENSOR_FIELDS:
        a, b = getattr(carried, f), getattr(built, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for f in META_FIELDS:
        assert getattr(carried, f) == getattr(built, f), f
    assert carried.to("cpu").device.type == "cpu"


def test_build_graph_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    g = parse_gfa_file(str(GRAPH_DIR / "tiny.gfa"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_graph(g, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_graph(g, "cpu").to("cuda")


def assert_same_arena(ref, port):
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert np.array_equal(a, b), f.name


@pytest.mark.parametrize("case", FIXTURE_GRAPHS + sorted(GENERATED))
def test_port_parser_matches_reference_arena(case, tmp_path):
    """The port's own parse_gfa / parse_gfa_file and load_flatgfa give
    the reference's arena, field by field (the reference's parse with
    and without its C++ scanner)."""
    if case in GENERATED:
        path = tmp_path / f"{case}.gfa"
        path.write_text(GENERATED[case]())
    else:
        path = GRAPH_DIR / case
    port = port_flatgfa.parse_gfa_file(str(path))
    for native in (True, False):
        assert_same_arena(parse_gfa(path.read_bytes(), native=native), port)
    assert_same_arena(parse_gfa_file(str(path)), port)
    binary = tmp_path / "g.flatgfa"
    ref_fileformat.save_flatgfa(str(binary), parse_gfa_file(str(path)), spare=0.5)
    assert_same_arena(
        ref_fileformat.load_flatgfa(str(binary)),
        port_fileformat.load_flatgfa(str(binary)),
    )


def test_port_parser_refuses_what_the_reference_refuses():
    for bad in (b"X\tfoo\n", b"S\t1\tACGT\nP\tp\t2+\t*\n", b"L\t1\t?\t1\t+\t0M\n"):
        with pytest.raises(ref_flatgfa.GFAParseError):
            parse_gfa(bad, native=False)
        with pytest.raises(port_flatgfa.GFAParseError):
            port_flatgfa.parse_gfa(bad)


COMMAND_LINES = [
    ["-I", "g.gfa", "depth"],
    ["-I", "g.gfa", "depth", "-d"],
    ["-I", "g.gfa", "depth", "-d", "-s", "sub.txt"],
    ["-I", "g.gfa", "depth", "-s", "sub.txt"],
    ["-i", "g.flatgfa", "depth", "-d", "-S", "batch.txt"],
    ["-I", "g.gfa", "depth", "-S", "batch.txt"],
    ["-I", "g.gfa", "depth", "-r", "a", "-r", "b"],
    ["-I", "g.gfa", "depth", "-b", "x.bed", "-S", "batch.txt"],
    ["--ell-objective", "batch", "-I", "g.gfa", "serve"],
    ["-I", "g.gfa", "-p", "0.5", "-m", "serve"],
    ["depth", "--graph-depth-table", "--subset-paths", "s"],
    [],
]


@pytest.mark.parametrize("argv", COMMAND_LINES, ids=lambda a: " ".join(a) or "empty")
def test_port_grammar_matches_reference(argv):
    """The port's build_parser parses a command line to the reference's
    namespace, plus ``--device``; _needs_masked_index agrees, except
    that ``depth -b`` builds no masked index in the port (the reference
    still builds them for ``-b`` with ``-S``, which the bed route never
    reads)."""
    ref = ref_cli.build_parser().parse_args(argv)
    port = port_cli.build_parser().parse_args(argv)
    assert port.device == "cuda"
    got = vars(port)
    del got["device"]
    assert got == vars(ref)
    want = ref_cli._needs_masked_index(ref) and not getattr(
        ref, "bed_input", None
    )
    assert port_cli._needs_masked_index(port) == want


# The reference writes -o/-O after every command (its _store), and so
# does the port: the file holds the reference's bytes and stdout the
# command's answer. (Until the port had a writer these tests checked that
# it refused both flags.)
@pytest.mark.parametrize("flag", ["-o", "-O"])
def test_cli_refuses_output_flags(flag, tmp_path, capsys):
    gfa = str(GRAPH_DIR / "loops.gfa")
    texts, files = [], []
    for who, run in (("ref", ref_run), ("port", port_run)):
        out_file = tmp_path / f"{who}.graph"
        texts.append(run(["-I", gfa, flag, str(out_file), "depth"]))
        files.append(out_file.read_bytes())
    assert texts[0] == texts[1] and texts[0]
    assert files[0] == files[1] and files[0]
    assert capsys.readouterr().err == ""


def test_serve_refuses_an_output_request(tmp_path):
    """Served ``-o`` and ``-O`` requests write the reference's bytes,
    answer ``##end\tok`` and serving goes on."""
    gfa = str(GRAPH_DIR / "loops.gfa")
    texts, files = [], []
    for who, run in (("ref", ref_run), ("port", port_run)):
        out_file = tmp_path / f"{who}.flatgfa"
        texts.append(run(["-I", gfa, "serve"],
                         f"depth -d\n-o {out_file} depth -d\n"
                         f"-O {out_file}.gfa\ndepth -d\n"))
        files.append(out_file.read_bytes())
        files.append((tmp_path / f"{who}.flatgfa.gfa").read_bytes())
    frames = [ln for ln in texts[1].splitlines() if ln.startswith("##end")]
    assert frames == ["##end\tok"] * 4
    assert texts[0] == texts[1]
    assert files[0] == files[2] and files[0]
    assert files[1] == files[3] == (GRAPH_DIR / "loops.gfa").read_bytes()
