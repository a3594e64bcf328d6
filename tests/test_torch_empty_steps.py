"""The port's one recorded departure on a graph whose paths hold no
steps: ``norm``, ``crush``, ``chop``, ``flip`` and ``inject`` print the
transformed graph where the reference fails.

The graph is one segment and one path with no steps. The reference's
NumPy emitter reads ``ends[-1]`` of the empty step-token array
(``pollen_tpu/emit.py:96``): its CLI raises ``IndexError`` and its
``serve`` answers ``##end\\terror\\t...``. The port's emitter guards the
empty case (``pollen_tpu_torch/emit.py`` ``_step_token_blob``) and
prints the graph. Each case asserts both halves, so a repaired
reference shows up here. Where the reference's native emitter is built,
it renders the reference's transformed arena with the same bytes as the
port's arena in preserved order. The port's cases run twice: with its
own native emitter (``pollen_tpu_torch.native``, the default where it
is built) and with ``POLLEN_NATIVE=0`` (the NumPy emitter and its
guard), with the same hand-written bytes.
"""

import pytest
import torch

from pollen_tpu import native as ref_native
from pollen_tpu.bed import parse_bed as ref_parse_bed
from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import parse_gfa as ref_parse_gfa
from pollen_tpu.ops import inject as ref_inject
from pollen_tpu.ops import transform as ref_transform
from pollen_tpu_torch import native as port_native
from pollen_tpu_torch.bed import parse_bed
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.emit import emit_gfa
from pollen_tpu_torch.flatgfa import parse_gfa
from pollen_tpu_torch.ops import inject as port_inject
from pollen_tpu_torch.ops import transform as port_transform
from test_torch_ops import port_run, ref_run

torch.set_num_threads(1)

GFA = b"S\t1\tACGT\nP\tx\t\t*\n"
BED = b"x\t0\t2\tr1\n"

# command -> (the CLI's bytes, the arena's bytes in preserved order):
# sorted order puts the injected path r1 before x.
EXPECTED = {
    "norm": ("S\t1\tACGT\nP\tx\t\t*\n",) * 2,
    "crush": ("S\t1\tACGT\nP\tx\t\t*\n",) * 2,
    "chop": ("S\t1\tAC\nS\t2\tGT\nP\tx\t\t*\n",) * 2,
    "flip": ("S\t1\tACGT\nP\tx\t\t*\n",) * 2,
    "inject": ("S\t1\tACGT\nP\tr1\t\t*\nP\tx\t\t*\n",
               "S\t1\tACGT\nP\tx\t\t*\nP\tr1\t\t*\n"),
}


def argv_of(command: str, bed: str) -> list:
    return {
        "norm": ["norm"],
        "crush": ["crush"],
        "chop": ["chop", "-c", "2"],
        "flip": ["flip"],
        "inject": ["inject", "--bed", bed],
    }[command]


def arenas(command: str):
    """The reference's and the port's transformed arenas."""
    g_ref, g = ref_parse_gfa(GFA), parse_gfa(GFA)
    if command == "norm":
        return g_ref, g
    if command == "crush":
        return ref_transform.crush(g_ref), port_transform.crush(g)
    if command == "chop":
        return ref_transform.chop(g_ref, 2), port_transform.chop(g, 2)
    if command == "flip":
        return (ref_transform.flip(g_ref, build_device_graph(g_ref))[0],
                port_transform.flip(g, build_graph(g, "cpu"))[0])
    return (ref_inject.inject(g_ref, ref_parse_bed(BED)),
            port_inject.inject(g, parse_bed(BED)))


def check_transform(command, mode, tmp_path):
    gfa, bed = tmp_path / "nosteps.gfa", tmp_path / "region.bed"
    gfa.write_bytes(GFA)
    bed.write_bytes(BED)
    argv = argv_of(command, str(bed))
    cli_bytes, preserved = EXPECTED[command]

    if mode == "cli":
        with pytest.raises(IndexError):
            ref_run(["-I", str(gfa), *argv])
        got = port_run(["-I", str(gfa), *argv])
        assert got == cli_bytes
    else:
        request = " ".join(argv) + "\n"
        ref = ref_run(["-I", str(gfa), "serve"], request)
        assert ref.startswith("##end\terror\t"), ref
        assert "out of bounds" in ref
        got = port_run(["-I", str(gfa), "serve"], request)
        assert got == cli_bytes + "##end\tok\n"


@pytest.mark.parametrize("mode", ["cli", "serve"])
@pytest.mark.parametrize("command", list(EXPECTED))
def test_transforms_on_a_graph_without_steps(command, mode, tmp_path):
    check_transform(command, mode, tmp_path)


@pytest.mark.parametrize("mode", ["cli", "serve"])
@pytest.mark.parametrize("command", list(EXPECTED))
def test_transforms_without_steps_under_pollen_native_0(
    command, mode, tmp_path, monkeypatch
):
    monkeypatch.setenv("POLLEN_NATIVE", "0")
    assert not port_native.native_available()
    check_transform(command, mode, tmp_path)


@pytest.mark.parametrize("command", list(EXPECTED))
def test_transformed_arena_against_the_native_emitter(command):
    """The port's transformed arena in preserved order is the
    hand-written text; so is the reference's, through its C++ emitter
    (its NumPy emitter fails here), where that emitter is built."""
    _, preserved = EXPECTED[command]
    ref_arena, port_arena = arenas(command)
    assert emit_gfa(port_arena, order="preserved") == preserved
    if not ref_native.native_available():
        pytest.skip("the reference's native emitter (pollen_tpu/native) is "
                    "not built here: no C++ compiler or POLLEN_NATIVE=0")
    assert ref_native.emit_gfa_native(ref_arena) == preserved


@pytest.mark.parametrize("command", list(EXPECTED))
def test_transformed_arena_through_both_port_emitters(command, monkeypatch):
    """The port's native emitter prints the hand-written text, and so
    does its NumPy emitter under POLLEN_NATIVE=0."""
    _, preserved = EXPECTED[command]
    _, port_arena = arenas(command)
    if not port_native.native_available():
        pytest.skip("the port's native emitter is not built here: no C++ "
                    "compiler")
    assert port_native.emit_gfa_native(port_arena) == preserved
    monkeypatch.setenv("POLLEN_NATIVE", "0")
    assert port_native.emit_gfa_native(port_arena) is None
    assert emit_gfa(port_arena, order="preserved") == preserved
