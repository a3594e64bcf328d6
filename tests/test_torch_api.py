"""The port's object API against the JAX reference's: every API case of
``tests/test_api.py``, run on both packages with the same expected
answers (the port's index built with ``device="cpu"``), the GAF lookup
printed by both, ``load_flatgfa_bytes`` (bad magic, truncation, the
hand-packed golden), and ``FlatGFA.device()``: built where its
``device`` says, and an error on a machine without a card when that
is the default, cuda.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import pollen_tpu
import pollen_tpu_torch
from conftest import GRAPH_DIR
from pollen_tpu import fileformat as ref_fileformat
from pollen_tpu_torch import fileformat as port_fileformat
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.flatgfa import parse_gfa, parse_gfa_file
from test_golden_binary import GOLDEN, TINY_GFA, hand_packed_flatgfa

torch.set_num_threads(1)

TINY = (
    "H\tVN:Z:1.0\n"
    "S\t1\tACGT\nS\t2\tTT\nS\t3\tGATTACA\nS\t4\tC\n"
    "P\talpha\t1+,2+,3+\t*\nP\tbeta\t1+,2+,4-\t*\n"
    "L\t1\t+\t2\t+\t0M\nL\t2\t+\t3\t+\t0M\nL\t2\t+\t4\t+\t0M\n"
)

PACKAGES = {
    "ref": types.SimpleNamespace(
        parse=pollen_tpu.parse, parse_bytes=pollen_tpu.parse_bytes,
        load=pollen_tpu.load,
    ),
    "port": types.SimpleNamespace(
        parse=functools.partial(pollen_tpu_torch.parse, device="cpu"),
        parse_bytes=functools.partial(pollen_tpu_torch.parse_bytes,
                                      device="cpu"),
        load=functools.partial(pollen_tpu_torch.load, device="cpu"),
    ),
}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture()
def g(pkg):
    return pkg.parse_bytes(TINY.encode())


def test_segments(g):
    assert len(g.segments) == 4
    seg = g.segments[0]
    assert seg.name == 1
    assert seg.sequence() == b"ACGT"
    assert len(seg) == 4
    assert [s.name for s in g.segments] == [1, 2, 3, 4]


def test_find(g):
    assert g.segments.find(3).sequence() == b"GATTACA"
    assert g.segments.find(99) is None
    assert g.paths.find(b"beta").id == 1
    assert g.paths.find(b"nope") is None


def test_path_steps(g):
    path = g.paths[0]
    assert path.name == b"alpha"
    assert len(path) == 3
    names = [h.segment.name for h in path]
    assert names == [1, 2, 3]
    assert path[2].segment.name == 3
    assert path[-1].is_forward
    rev_handle = g.paths[1][2]
    assert not rev_handle.is_forward


def test_step_slicing(g):
    path = g.paths[0]
    sl = path[1:3]
    assert len(sl) == 2
    assert [h.segment.name for h in sl] == [2, 3]


def test_links(g):
    assert len(g.links) == 3
    lnk = g.links[0]
    assert lnk.from_.segment.name == 1
    assert lnk.to.segment.name == 2


def test_eq_and_hash(g):
    assert g.segments[0] == g.segments[0]
    assert g.segments[0] != g.segments[1]
    assert len({g.paths[0], g.paths[0], g.paths[1]}) == 2
    assert g.paths[0][0] == g.paths[1][0]  # same handle 1+


def test_reprs(g):
    assert repr(g.segments[2]) == "<Segment 3>"
    assert repr(g.paths[1]) == "<Path beta>"
    assert repr(g.paths[1][2]) == "<Handle 4->"
    assert repr(g.links[0]) == "<Link <Handle 1+> -> <Handle 2+>>"


def test_str_roundtrip(g):
    assert str(g) == TINY


def test_file_roundtrips(pkg, g, tmp_path):
    gfa = tmp_path / "t.gfa"
    flat = tmp_path / "t.flatgfa"
    g.write_gfa(str(gfa))
    g.write_flatgfa(str(flat))
    assert str(pkg.parse(str(gfa))) == TINY
    assert str(pkg.load(str(flat))) == TINY


def test_pangenotype_api(g, tmp_path):
    f1 = tmp_path / "a.gaf"
    f1.write_bytes(b"r\t6\t0\t6\t+\t>1>2\t6\t0\t6\t6\t6\t60\n")
    mat = g.make_pangenotype_matrix([str(f1)])
    assert mat == [[True, True, False, False]]


ALL_READS_GFA = (
    b"H\tVN:Z:1.0\n"
    b"S\t1\tCAAATAAG\nS\t2\tAAATTTTCTGGAGTTCTAT\nS\t3\tTTG\n"
    b"S\t4\tCCAACTCTCTG\n"
    b"P\tone\t1+,2+,4-\t*\nP\ttwo\t1+,2+,3+,4-\t*\n"
    b"L\t1\t+\t2\t+\t0M\nL\t2\t+\t4\t-\t0M\n"
    b"L\t2\t+\t3\t+\t0M\nL\t3\t+\t4\t-\t0M\n"
)
ALL_READS_GAF = (
    b"foo\t12\t0\t12\t+\t>1>2<4\t38\t5\t17\t12\t12\t0\tcg:Z:150M\n"
    b"bar\t20\t0\t20\t+\t>1>2>3\t30\t7\t27\t20\t20\t0\tcg:Z:150M\n"
)


def test_all_reads_object_surface(pkg, tmp_path):
    """GAFParser / GAFLine / ChunkEvent match the reference's flatgfa-py
    semantics (its test_gaf.py expectations reproduced verbatim on its
    fixture shapes)."""
    gaf = tmp_path / "tiny.gaf"
    gaf.write_bytes(ALL_READS_GAF)
    g = pkg.parse_bytes(ALL_READS_GFA)
    lines = list(g.all_reads(str(gaf)))
    assert [ln.name for ln in lines] == ["foo", "bar"]
    seqs = ["".join(e.sequence() for e in line) for line in lines]
    assert seqs == ["AAGAAATTTTCT", "GAAATTTTCTGGAGTTCTAT"]
    ranges = [[e.range for e in line] for line in lines]
    assert ranges == [
        [(5, 8), (0, 9), (1, 0)],
        [(7, 8), (0, 18), (0, 0)],
    ]
    assert lines[0].sequence() == "AAGAAATTTTCT"
    assert lines[0].segment_ranges().startswith("\n0: 1+, 5-8bp")


def test_all_reads_and_lookup_equal_the_reference(tmp_path, capsys):
    """Every GAFLine's text and each printed lookup, port against
    reference, on the all_reads fixture."""
    gaf = tmp_path / "tiny.gaf"
    gaf.write_bytes(ALL_READS_GAF)
    out = {}
    for name, pkg in PACKAGES.items():
        g = pkg.parse_bytes(ALL_READS_GFA)
        lines = list(g.all_reads(str(gaf)))
        text = [(ln.name, ln.sequence(), ln.segment_ranges(),
                 [(e.handle.seg_id, e.handle.is_forward, e.range)
                  for e in ln]) for ln in lines]
        g.print_gaf_lookup(str(gaf))
        out[name] = (text, capsys.readouterr().out)
    assert out["port"] == out["ref"]
    assert out["port"][1].startswith("foo\n0: 1+, 5-8bp")


# -- load_flatgfa_bytes ------------------------------------------------------


def test_load_flatgfa_bytes_bad_magic_rejected():
    for mod in (ref_fileformat, port_fileformat):
        with pytest.raises(mod.FlatFileError):
            mod.load_flatgfa_bytes(b"\x00" * 200)


def test_load_flatgfa_bytes_truncated_rejected(graph_path, tmp_path):
    out = tmp_path / "g.flatgfa"
    port_fileformat.save_flatgfa(str(out), parse_gfa_file(str(graph_path)))
    data = out.read_bytes()
    for mod in (ref_fileformat, port_fileformat):
        with pytest.raises(mod.FlatFileError):
            mod.load_flatgfa_bytes(data[: len(data) // 2])
    # Whole, it loads back the same arena on both.
    ref, port = (mod.load_flatgfa_bytes(data)
                 for mod in (ref_fileformat, port_fileformat))
    for field in dataclasses.fields(port):
        np.testing.assert_array_equal(getattr(port, field.name),
                                      getattr(ref, field.name),
                                      err_msg=field.name)


def test_load_flatgfa_bytes_golden_round_trip(tmp_path):
    """The port writes the hand-packed layout and the committed fixture,
    and loading the hand-packed bytes gives the parsed arena."""
    g = parse_gfa(TINY_GFA)
    path = tmp_path / "tiny.flatgfa"
    port_fileformat.save_flatgfa(str(path), g)
    expected = hand_packed_flatgfa()
    assert path.read_bytes() == expected
    fixture = bytes.fromhex((GOLDEN / "tiny.flatgfa.hex").read_text().strip())
    assert expected == fixture
    g2 = port_fileformat.load_flatgfa_bytes(expected)
    for field in dataclasses.fields(g):
        np.testing.assert_array_equal(getattr(g2, field.name),
                                      getattr(g, field.name),
                                      err_msg=field.name)


# -- FlatGFA.device() --------------------------------------------------------


def test_device_on_cpu_equals_build_graph():
    from pollen_tpu_torch.device import META_FIELDS, TENSOR_FIELDS

    g = pollen_tpu_torch.parse(str(GRAPH_DIR / "tiny.gfa"), device="cpu")
    dg = g.device()
    assert g.device() is dg  # built once, cached
    want = build_graph(g.arrays, "cpu")
    assert dg.device == torch.device("cpu")
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(dg, f), getattr(want, f)), f
    for f in META_FIELDS:
        assert getattr(dg, f) == getattr(want, f), f


@pytest.mark.parametrize("make", ["parse", "parse_bytes", "load", "FlatGFA"])
def test_device_defaults_to_cuda_and_raises_without_a_card(
    make, monkeypatch, tmp_path
):
    """cuda is the default for every constructor; with no card,
    ``device()`` raises and nothing is built on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(GRAPH_DIR / "tiny.gfa")
    if make == "parse":
        g = pollen_tpu_torch.parse(path)
    elif make == "parse_bytes":
        g = pollen_tpu_torch.parse_bytes(TINY.encode())
    elif make == "load":
        flat = tmp_path / "t.flatgfa"
        port_fileformat.save_flatgfa(str(flat), parse_gfa_file(path))
        g = pollen_tpu_torch.load(str(flat))
    else:
        g = pollen_tpu_torch.FlatGFA(parse_gfa_file(path))
    assert g.torch_device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        g.device()
    assert g._dg is None
