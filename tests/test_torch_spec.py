"""The port's copy of the executable spec (``pollen_tpu_torch.spec``):
every case of ``tests/test_spec.py`` on the copy, and the copy's
output against the reference spec's (``pollen_tpu.spec``) for every
command on seeded ``graphgen`` graphs, byte for byte; its CLI
(``python -m pollen_tpu_torch.spec``) reads a file or stdin."""

import io
import subprocess
import sys

import pytest

from conftest import GOLDEN_DIR, GRAPH_DIR, REPO
from graphgen import random_graph
from pollen_tpu.spec import commands as ref_commands
from pollen_tpu.spec.model import Bed as RefBed
from pollen_tpu.spec.model import Graph as RefGraph
from pollen_tpu_torch.spec import commands
from pollen_tpu_torch.spec.model import Bed, Cigar, Graph, Handle, Link, revcomp


def run_spec(args, stdin=None, module="pollen_tpu_torch.spec"):
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        capture_output=True,
        text=True,
        input=stdin,
        check=True,
        cwd=REPO,
    ).stdout


# -- model basics -----------------------------------------------------------


def test_revcomp():
    assert revcomp("ACGTN") == "NACGT"
    assert revcomp("") == ""
    assert revcomp("GATTACA") == "TGTAATC"


def test_cigar_roundtrip():
    for text in ["0M", "3M1D2M", "10N", "5I"]:
        assert str(Cigar.parse(text)) == text


def test_link_canonicalization():
    ab = Link(Handle("2", True), Handle("1", False), Cigar.parse("0M"))
    assert str(ab) == "L\t1\t+\t2\t-\t0M"
    self_rev = Link(Handle("3", False), Handle("3", True), Cigar.parse("0M"))
    assert str(self_rev) == "L\t3\t-\t3\t+\t0M"


def test_parse_emit_roundtrip(graph_path):
    graph = Graph.parse_file(str(graph_path))
    out = io.StringIO()
    graph.emit(out)
    # Normalized emission is a fixpoint.
    again = Graph.parse(io.StringIO(out.getvalue()))
    out2 = io.StringIO()
    again.emit(out2)
    assert out.getvalue() == out2.getvalue()


# -- golden parity ----------------------------------------------------------

PRINTER_GOLDENS = [
    "depth",
    "degree",
    "matrix",
    "paths",
    "validate",
    "flatten",
    "overlap",
]

TRANSFORM_GOLDENS = ["norm", "crush", "flip", "chop", "inject"]


def spec_output(cmds, model_bed, graph, kind, stem, beds_text=None):
    """One command's text from the spec ``cmds`` (either package's)."""
    out = io.StringIO()
    if kind == "depth":
        cmds.depth(graph, out)
    elif kind == "depth_subset":
        cmds.depth(graph, out, list(graph.paths)[::2])
    elif kind == "degree":
        cmds.degree(graph, out)
    elif kind == "matrix":
        cmds.matrix(graph, out)
    elif kind == "paths":
        cmds.paths(graph, out)
    elif kind == "validate":
        cmds.validate(graph, out)
    elif kind == "flatten":
        cmds.flatten(graph, out, f"tests/graphs/{stem}.og")
    elif kind == "overlap":
        cmds.overlap(graph, out, list(graph.paths))
    elif kind == "somepaths":
        cmds.some_paths(graph, out, 30)
    elif kind == "inject_setup":
        cmds.inject_setup(graph, out)
    else:
        if kind == "norm":
            result = cmds.norm(graph)
        elif kind == "crush":
            result = cmds.crush(graph)
        elif kind == "flip":
            result = cmds.flip(graph)
        elif kind == "chop":
            result = cmds.chop(graph, 3)
        elif kind == "validate_setup":
            result = cmds.validate_setup(graph)
        else:  # inject
            beds = [model_bed.parse(ln) for ln in beds_text.splitlines() if ln]
            result = cmds.inject(graph, beds)
        result.emit(out, kind not in ("chop", "inject"))
    return out.getvalue()


@pytest.mark.parametrize("kind", PRINTER_GOLDENS + TRANSFORM_GOLDENS)
def test_goldens(graph_path, kind):
    stem = graph_path.stem
    golden = (GOLDEN_DIR / f"{stem}.{kind}").read_text()
    graph = Graph.parse_file(str(graph_path))
    beds = (GOLDEN_DIR / f"{stem}.bed").read_text() if kind == "inject" else None
    assert spec_output(commands, Bed, graph, kind, stem, beds) == golden


def test_depth_subset_golden(graph_path):
    stem = graph_path.stem
    golden = (GOLDEN_DIR / f"{stem}.depth_subset").read_text()
    subset = [
        ln
        for ln in (GOLDEN_DIR / f"{stem}.depthpaths").read_text().splitlines()
        if ln
    ]
    graph = Graph.parse_file(str(graph_path))
    out = io.StringIO()
    commands.depth(graph, out, subset)
    assert out.getvalue() == golden


def test_chop_preserves_paths(graph_path):
    graph = Graph.parse_file(str(graph_path))
    chopped = commands.chop(graph, 2)
    assert commands.paths_preserved(graph, chopped)


def test_cli_stdin_matches_file():
    gpath = GRAPH_DIR / "tiny.gfa"
    by_file = run_spec(["paths", str(gpath)])
    by_stdin = run_spec(["paths"], stdin=gpath.read_text())
    assert by_file == by_stdin


# -- the copy against the reference spec -----------------------------------

ALL_KINDS = PRINTER_GOLDENS + TRANSFORM_GOLDENS + [
    "depth_subset", "somepaths", "inject_setup", "validate_setup",
]
SEEDS = [11, 12, 13, 21]


@pytest.mark.parametrize("kind", ALL_KINDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_copy_matches_the_reference_spec(seed, kind):
    text = random_graph(seed=seed, n_segs=35, n_paths=7, n_frac=0.15,
                        walk_len=30)
    graph = Graph.parse_lines(iter(text.splitlines()))
    ref_graph = RefGraph.parse_lines(iter(text.splitlines()))
    beds = None
    if kind == "inject":
        # Regions from the spec's own seeded setup command.
        setup = io.StringIO()
        ref_commands.inject_setup(ref_graph, setup)
        beds = setup.getvalue()
    got = spec_output(commands, Bed, graph, kind, f"r{seed}", beds)
    want = spec_output(ref_commands, RefBed, ref_graph, kind, f"r{seed}", beds)
    assert got == want


@pytest.mark.parametrize(
    "args",
    [["depth"], ["degree"], ["flip"], ["chop", "-n", "3"], ["norm", "--nl"],
     ["matrix"], ["validate"]],
)
def test_cli_matches_the_reference_cli(args, tmp_path):
    """``python -m pollen_tpu_torch.spec`` prints what ``python -m
    pollen_tpu.spec`` prints, from a file and from stdin."""
    gfa = tmp_path / "r.gfa"
    gfa.write_text(random_graph(seed=12, n_segs=35, n_paths=7))
    want = run_spec([*args, str(gfa)], module="pollen_tpu.spec")
    assert run_spec([*args, str(gfa)]) == want
    assert run_spec(args, stdin=gfa.read_text()) == want
