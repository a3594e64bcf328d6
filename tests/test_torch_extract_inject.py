"""The port's host copies of ``extract``, ``inject``, ``packedseq`` and
``bench --wcl`` against the JAX package on the CPU, exactly: each
library call's arena and text against the reference's on the fixtures
and on seeded generated graphs, the goldens (``*.inject``,
``tiny.packedseq.hex``), and every command line (with ``-o``/``-O``
and ``serve``) through both CLIs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import FIXTURE_GRAPHS, GOLDEN_DIR, GRAPH_DIR
from graphgen import random_graph
from pollen_tpu import packedseq as ref_packedseq
from pollen_tpu.bed import parse_bed as ref_parse_bed
from pollen_tpu.emit import emit_gfa as ref_emit_gfa
from pollen_tpu.flatgfa import parse_gfa as ref_parse_gfa
from pollen_tpu.ops import bench as ref_bench
from pollen_tpu.ops.extract import extract as ref_extract
from pollen_tpu.ops.inject import inject as ref_inject
from pollen_tpu_torch import packedseq
from pollen_tpu_torch.bed import parse_bed
from pollen_tpu_torch.emit import emit_gfa
from pollen_tpu_torch.flatgfa import GFAParseError, parse_gfa
from pollen_tpu_torch.ops import bench
from pollen_tpu_torch.ops.extract import extract
from pollen_tpu_torch.ops.inject import inject
from test_torch_ops import port_run, ref_run

torch.set_num_threads(1)

GENERATED = {
    "gen_rand_s0": lambda: random_graph(n_segs=25, n_paths=5, seed=0,
                                        n_frac=0.0),
    "gen_rand_s9": lambda: random_graph(n_segs=30, n_paths=6, seed=9,
                                        n_frac=0.0),
    "gen_rand_big": lambda: random_graph(n_segs=200, n_paths=24, seed=3),
}
CASES = FIXTURE_GRAPHS + sorted(GENERATED)


def graph_text(name: str) -> bytes:
    if name in GENERATED:
        return GENERATED[name]().encode()
    return (GRAPH_DIR / name).read_bytes()


def assert_arenas_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


# ---------------------------------------------------------------------------
# extract
# ---------------------------------------------------------------------------


def extract_cases(g):
    names = g.seg_name
    picks = sorted({int(names[0]), int(names[len(names) // 2]),
                    int(names[-1])})
    return [(name, dist, maxd, iters)
            for name in picks
            for dist, maxd, iters in ((0, 300_000, 6), (1, 300_000, 6),
                                      (2, 6, 3), (3, 0, 1), (1, 1000, 0))]


@pytest.mark.parametrize("name", CASES)
def test_extract_matches_reference(name):
    data = graph_text(name)
    g, g_ref = parse_gfa(data), ref_parse_gfa(data)
    for case in extract_cases(g):
        got = extract(g, *case)
        want = ref_extract(g_ref, *case)
        assert_arenas_equal(got, want)
        for order in ("normalized", "sorted"):
            assert emit_gfa(got, order=order) == ref_emit_gfa(
                want, order=order), (case, order)


def test_extract_of_an_absent_segment_is_the_reference_error():
    data = (GRAPH_DIR / "tiny.gfa").read_bytes()
    with pytest.raises(GFAParseError, match="unknown segment name"):
        extract(parse_gfa(data), 999, 1)
    with pytest.raises(ValueError, match="unknown segment name"):
        ref_extract(ref_parse_gfa(data), 999, 1)


# ---------------------------------------------------------------------------
# inject
# ---------------------------------------------------------------------------


def seeded_bed(g, seed: int) -> bytes:
    """Non-empty regions of the graph's paths (their ends mostly
    mid-segment), each named by its 4th column, and one region of an
    absent path."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(4):
        p = int(rng.integers(0, g.num_paths))
        steps = g.path_step_slice(p)
        total = int(g.seg_len[(steps >> 1).astype(np.int64)].sum())
        if total < 1:
            continue
        lo = int(rng.integers(0, total))
        hi = int(rng.integers(lo + 1, total + 1))
        rows.append(f"{g.path_name_bytes(p).decode()}\t{lo}\t{hi}\tr{i}\n")
    rows.append("no_such_path\t0\t5\tghost\n")
    return "".join(rows).encode()


@pytest.mark.parametrize("name", CASES)
def test_inject_matches_reference_and_goldens(name):
    data = graph_text(name)
    g, g_ref = parse_gfa(data), ref_parse_gfa(data)
    beds = [seeded_bed(g, s) for s in (0, 1)]
    if name in FIXTURE_GRAPHS:
        beds.append((GOLDEN_DIR / f"{name[:-4]}.bed").read_bytes())
    for bed in beds:
        got = inject(g, parse_bed(bed))
        want = ref_inject(g_ref, ref_parse_bed(bed))
        assert_arenas_equal(got, want)
        assert emit_gfa(got, order="sorted", include_links=False) == (
            ref_emit_gfa(want, order="sorted", include_links=False))
    if name in FIXTURE_GRAPHS:
        assert emit_gfa(got, order="sorted", include_links=False) == (
            GOLDEN_DIR / f"{name[:-4]}.inject").read_text()


def test_inject_midsegment_cut_matches_reference():
    data = b"S\t1\tAAAA\nS\t2\tCCCC\nP\tp\t1+,2+\t*\nL\t1\t+\t2\t+\t0M\n"
    for bed in (b"p\t2\t6\tmid\n", b"p\t2\t6\tmid\np\t1\t3\tsecond\n"):
        got = inject(parse_gfa(data), parse_bed(bed))
        want = ref_inject(ref_parse_gfa(data), ref_parse_bed(bed))
        assert_arenas_equal(got, want)
        text = emit_gfa(got, order="sorted", include_links=False)
        assert text == ref_emit_gfa(want, order="sorted",
                                    include_links=False)
    # Each cut of the second region splits one more segment.
    assert "P\tmid\t3+,4+,5+\t*" in text and "P\tsecond\t2+,3+\t*" in text


def test_inject_keeps_the_reference_fault_on_an_empty_region():
    """A region past its path's end adds an empty path; a later cut then
    indexes past the step pool, in the reference as in the port (the
    reference's fault, kept for parity: ROADMAP §3)."""
    data = b"S\t1\tAAAA\nS\t2\tCCCC\nP\tp\t1+,2+\t*\n"
    bed = b"p\t9\t12\tpast\np\t1\t3\tcut\n"
    with pytest.raises(IndexError):
        inject(parse_gfa(data), parse_bed(bed))
    with pytest.raises(IndexError):
        ref_inject(ref_parse_gfa(data), ref_parse_bed(bed))


# ---------------------------------------------------------------------------
# packedseq
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [0, 1, 2, 7, 60, 1001])
def test_packedseq_matches_reference(length):
    rng = np.random.default_rng(length)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)]
    seq = seq.tobytes()
    got = packedseq.PackedSeq.from_ascii(seq)
    want = ref_packedseq.PackedSeq.from_ascii(seq)
    assert got.high_nibble_end == want.high_nibble_end
    np.testing.assert_array_equal(got.data, want.data)
    assert len(got) == len(want) == length
    blob = got.to_file_bytes()
    assert blob == want.to_file_bytes()
    back = packedseq.PackedSeq.from_file_bytes(blob)
    assert back.to_ascii() == seq
    assert [back[i] for i in range(length)] == [chr(c) for c in seq]
    assert packedseq.TOC_DTYPE == ref_packedseq.TOC_DTYPE


def test_packedseq_golden_and_errors(tmp_path):
    want = bytes.fromhex((GOLDEN_DIR / "tiny.packedseq.hex").read_text()
                         .strip())
    assert packedseq.PackedSeq.from_ascii(b"ACTGA").to_file_bytes() == want
    raw = tmp_path / "tiny.txt"
    raw.write_bytes(b"AC\r\nT G\tA\n")
    packedseq.seq_export(str(raw), str(tmp_path / "port.ps"))
    ref_packedseq.seq_export(str(raw), str(tmp_path / "ref.ps"))
    assert (tmp_path / "port.ps").read_bytes() == want
    assert (tmp_path / "ref.ps").read_bytes() == want
    assert packedseq.seq_import(str(tmp_path / "port.ps")) == b"ACTGA"
    for bad, port_call, ref_call in (
        (b"ACNG", lambda b: packedseq.PackedSeq.from_ascii(b),
         lambda b: ref_packedseq.PackedSeq.from_ascii(b)),
        (b"\x12\x00", lambda b: packedseq.PackedSeq.from_file_bytes(b),
         lambda b: ref_packedseq.PackedSeq.from_file_bytes(b)),
        (b"\x13" + want[1:],
         lambda b: packedseq.PackedSeq.from_file_bytes(b),
         lambda b: ref_packedseq.PackedSeq.from_file_bytes(b)),
    ):
        with pytest.raises(packedseq.PackedSeqError) as got:
            port_call(bad)
        with pytest.raises(ref_packedseq.PackedSeqError) as ref:
            ref_call(bad)
        assert str(got.value) == str(ref.value)
    assert str(got.value) == "bad magic: not a packed-seq file"


# ---------------------------------------------------------------------------
# bench --wcl
# ---------------------------------------------------------------------------


def test_line_count_serial_and_parallel(tmp_path):
    path = tmp_path / "lines.txt"
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 80, 30000)
    path.write_bytes(b"".join(b"y" * int(k) + b"\n" for k in rows) + b"tail")
    assert path.stat().st_size > 1 << 20
    for parallel in (False, True):
        assert bench.line_count(str(path), parallel) == rows.shape[0]
        assert ref_bench.line_count(str(path), parallel) == rows.shape[0]
    small = tmp_path / "small.txt"
    small.write_bytes(b"a\nb\n\n")
    assert bench.line_count(str(small), True) == 3


# ---------------------------------------------------------------------------
# The commands, through both CLIs
# ---------------------------------------------------------------------------


def command_lines(stem: str, g) -> list:
    bed = str(GOLDEN_DIR / f"{stem}.bed")
    mid = str(int(g.seg_name[g.num_segments // 2]))
    return [
        ["inject", "--bed", bed],
        ["extract", "-n", mid, "-c", "1"],
        ["extract", "-n", mid, "-c", "2", "-d", "4", "-e", "2"],
        ["extract", "-n", str(int(g.seg_name[0])), "-c", "3", "-d", "0"],
    ]


@pytest.mark.parametrize("stem", [f[:-4] for f in FIXTURE_GRAPHS])
def test_commands_match_reference(stem, tmp_path):
    gfa = str(GRAPH_DIR / f"{stem}.gfa")
    g = parse_gfa((GRAPH_DIR / f"{stem}.gfa").read_bytes())
    for argv in command_lines(stem, g):
        got = port_run(["-I", gfa, *argv])
        assert got and got == ref_run(["-I", gfa, *argv]), argv
        for flag, ext in (("-o", "flatgfa"), ("-O", "gfa")):
            outs = []
            for run, who in ((port_run, "port"), (ref_run, "ref")):
                out = tmp_path / f"{who}.{ext}"
                assert run(["-I", gfa, flag, str(out), *argv]) == (
                    "" if argv[0] == "extract" else got), (flag, argv)
                outs.append(out.read_bytes())
            assert outs[0] == outs[1], (flag, argv)
    assert port_run(["-I", gfa, "inject", "--bed",
                     str(GOLDEN_DIR / f"{stem}.bed")]) == (
        GOLDEN_DIR / f"{stem}.inject").read_text()


def test_extract_writes_the_subgraph_and_inject_the_input(tmp_path):
    """extract's -o is the subgraph and nothing else is stored; inject's
    -o is the input graph (the reference's final store), -m rewrites the
    -i binary in place."""
    gfa = str(GRAPH_DIR / "rand1.gfa")
    sub = tmp_path / "sub.gfa"
    port_run(["-I", gfa, "-O", str(sub), "extract", "-n", "3", "-c", "1"])
    assert sub.read_text() == port_run(
        ["-I", gfa, "extract", "-n", "3", "-c", "1"])
    whole = tmp_path / "whole.gfa"
    port_run(["-I", gfa, "-O", str(whole), "inject", "--bed",
              str(GOLDEN_DIR / "rand1.bed")])
    assert whole.read_text() == (GRAPH_DIR / "rand1.gfa").read_text()
    binaries = []
    for run, who in ((port_run, "port"), (ref_run, "ref")):
        flat = tmp_path / f"{who}.flatgfa"
        run(["-I", gfa, "-p", "3", "-o", str(flat)])  # room for new rows
        run(["-i", str(flat), "-m", "inject", "--bed",
             str(GOLDEN_DIR / "rand1.bed")])
        binaries.append(flat.read_bytes())
    assert binaries[0] == binaries[1]


def test_seq_and_bench_commands_match_reference(tmp_path):
    raw = tmp_path / "bases.txt"
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 12345)]
    raw.write_bytes(b"\n".join(bases[i:i + 60].tobytes()
                               for i in range(0, bases.shape[0], 60)))
    outs = []
    for run, who in ((port_run, "port"), (ref_run, "ref")):
        packed = tmp_path / f"{who}.ps"
        assert run(["seq-export", str(raw), str(packed)]) == ""
        outs.append(packed.read_bytes())
        assert run(["seq-import", str(packed)]) == bases.tobytes().decode() \
            + "\n"
    assert outs[0] == outs[1]
    lines = tmp_path / "lines.txt"
    lines.write_bytes(b"".join(b"z" * (i % 70) + b"\n" for i in range(40000)))
    assert lines.stat().st_size > 1 << 20  # -p splits it
    for argv, want in ((["bench", "--wcl", str(lines)], "40000\n"),
                       (["bench", "--wcl", str(lines), "-p"], "40000\n"),
                       (["bench"], "")):
        assert port_run(argv) == ref_run(argv) == want, argv


def test_serve_answers_extract_and_inject_as_the_reference(tmp_path):
    gfa = str(GRAPH_DIR / "rand1.gfa")
    bed = str(GOLDEN_DIR / "rand1.bed")
    requests = [
        "extract -n 3 -c 2", f"inject --bed {bed}", "depth -d",
        f"-o {tmp_path / 'sub.flatgfa'} extract -n 4 -c 1",
        "extract -n 999 -c 1", "inject --bed /no/such.bed",
        f"seq-import {bed}", f"bench --wcl {bed}",
    ]
    text = "\n".join(requests) + "\n"
    got = port_run(["-I", gfa, "serve"], text)
    assert got == ref_run(["-I", gfa, "serve"], text)
    assert got.count("##end\tok\n") == 4
    assert "##end\terror\tcommand 'bench' is not served" in got
