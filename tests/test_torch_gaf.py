"""The port's GAF module (``pollen_tpu_torch/ops/gaf.py``) against the JAX
reference on the CPU, exactly: the parser field by field, the chunker's
kind/a/b bit for bit against the reference's jitted ``chunk_reads`` on
a ``build_device_graph`` of the same graph (random graphs and reads,
and the edge cases), the lookup's three modes, the windowed stream and
its spawned workers, the pangenotype matrix, and the ``gaf``,
``matrix`` and ``pangenotype`` command lines and their ``serve``
requests through both CLIs.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXTURE_GRAPHS, GRAPH_DIR
from graphgen import random_graph
from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import GFAParseError as RefGFAParseError
from pollen_tpu.flatgfa import parse_gfa as ref_parse_gfa
from pollen_tpu.ops import gaf as ref_gaf
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.flatgfa import GFAParseError, parse_gfa
from pollen_tpu_torch.ops import gaf as port_gaf
from pollen_tpu_torch.synth import synth_gaf
from test_torch_ops import port_run, ref_run

torch.set_num_threads(1)

REPO = GRAPH_DIR.parent.parent
EXAMPLE_GFA = REPO / "examples" / "example.gfa"
EXAMPLE_GAF = REPO / "examples" / "example.gaf"

# Segments of 4, 3, 5 and 2 bp: seams at 4, 7 and 12.
SMALL_GFA = (
    b"H\tVN:Z:1.0\n"
    b"S\t1\tAAAA\nS\t2\tCCC\nS\t3\tGGGGG\nS\t4\tTT\n"
    b"P\tp\t1+,2+,3+,4+\t*\n"
    b"L\t1\t+\t2\t+\t0M\nL\t2\t+\t3\t+\t0M\nL\t3\t+\t4\t+\t0M\n"
)
EDGE_GAFS = {
    "empty": b"",
    "blank_lines": b"\n\n",
    "no_steps": b"r0\t0\t0\t0\t+\t*\t0\t0\t0\t0\t0\t60\n"
                b"r1\t14\t0\t14\t+\t>1>2\t7\t1\t6\t5\t5\t60\n"
                b"r2\t0\t0\t0\t+\t*\t0\t0\t0\t0\t0\t60\n",
    "reverse": b"r\t14\t0\t14\t+\t<3<2<1\t12\t2\t11\t9\t9\t60\n"
               b"s\t14\t0\t14\t+\t>4<1>3\t11\t0\t11\t9\t9\t60\n",
    "seams": b"a\t14\t0\t14\t+\t>1>2>3>4\t14\t4\t7\t9\t9\t60\n"
             b"b\t14\t0\t14\t+\t>1>2>3>4\t14\t0\t4\t9\t9\t60\n"
             b"c\t14\t0\t14\t+\t>1>2>3>4\t14\t7\t14\t9\t9\t60\n"
             b"d\t14\t0\t14\t+\t>1>2>3>4\t14\t12\t14\t9\t9\t60\n",
    "no_trailing_newline": b"r\t14\t0\t14\t+\t>2>3\t8\t3\t5\t9\t9\t60",
}
GENERATED = {
    "gen_rand_s0": lambda: random_graph(n_segs=60, n_paths=8, seed=0),
    "gen_rand_s3": lambda: random_graph(n_segs=200, n_paths=24, seed=3),
}


def graph_text(name: str) -> bytes:
    if name == "small":
        return SMALL_GFA
    if name in GENERATED:
        return GENERATED[name]().encode()
    return (GRAPH_DIR / name).read_bytes()


def both_from(data: bytes):
    """(reference arena, reference device graph, port arena, port graph)
    of one GFA text, each package parsing it."""
    g_ref, g = ref_parse_gfa(data), parse_gfa(data)
    return (g_ref, build_device_graph(g_ref, cross_matrix="never"), g,
            build_graph(g, "cpu", cross_matrix="never"))


def both(name: str):
    return both_from(graph_text(name))


def assert_reads_equal(got, want):
    for field in ("name_data", "name_span", "start", "end", "steps",
                  "read_bounds"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def read_sets(name, g):
    """Seeded GAFs of a graph's path sub-walks, and the edge cases on the
    small graph."""
    if name == "small":
        return list(EDGE_GAFS.values()) + [synth_gaf(g, 40, seed=1,
                                                     max_steps=6)]
    return [synth_gaf(g, 60, seed=s, max_steps=m)
            for s, m in ((0, 40), (1, 3))]


CASES = ["small", *FIXTURE_GRAPHS, *sorted(GENERATED)]


@pytest.mark.parametrize("name", CASES)
def test_parse_and_chunks_match_reference(name):
    g_ref, dg_ref, g, dg = both(name)
    for data in read_sets(name, g):
        reads = port_gaf.parse_gaf(data, g.seg_id_by_name())
        ref_reads = ref_gaf.parse_gaf(data, g_ref.seg_id_by_name())
        assert_reads_equal(reads, ref_reads)
        got = port_gaf.chunk_events(g, dg, reads)
        want = ref_gaf.chunk_events(g_ref, dg_ref, ref_reads)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", range(4))
def test_chunk_reads_matches_reference_random(seed):
    """The reference's random-chunker shape (12 segments of 1-8 bp,
    reads of 1-7 random steps), called directly on both devices' arrays,
    and the numpy formula of the state machine in ``chip_smoke.py``."""
    from chip_smoke import numpy_chunker

    rng = np.random.default_rng(seed)
    n = 12
    lens = rng.integers(1, 9, n)
    data = ("H\tVN:Z:1.0\n" + "".join(
        f"S\t{i + 1}\t{'A' * int(x)}\n" for i, x in enumerate(lens)
    ) + "P\tp\t1+\t*\n").encode()
    g_ref, dg_ref, g, dg = both_from(data)
    lines = []
    for r in range(40):
        k = int(rng.integers(1, 8))
        segs = rng.integers(0, n, k)
        revs = rng.integers(0, 2, k)
        total = int(lens[segs].sum())
        start = int(rng.integers(0, total))
        end = int(rng.integers(start + 1, total + 1))
        path = "".join(f"{'<' if v else '>'}{s + 1}"
                       for s, v in zip(segs, revs))
        lines.append(f"r{r}\t{total}\t0\t{total}\t+\t{path}\t{total}\t"
                     f"{start}\t{end}\t1\t1\t60")
    reads = port_gaf.parse_gaf(("\n".join(lines) + "\n").encode(),
                               g.seg_id_by_name())
    read_id = np.repeat(np.arange(reads.num_reads, dtype=np.int32),
                        np.diff(reads.read_bounds))
    got = port_gaf.chunk_reads(
        dg.seg_len, torch.from_numpy(reads.steps.view(np.int32)),
        torch.from_numpy(read_id), torch.from_numpy(reads.start),
        torch.from_numpy(reads.end),
    )
    want = ref_gaf.chunk_reads(
        dg_ref.seg_len, jnp.asarray(reads.steps), jnp.asarray(read_id),
        jnp.asarray(reads.start), jnp.asarray(reads.end),
    )
    for x, y in zip(got, want):
        assert x.numpy().dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    kind, a, b = numpy_chunker(g.seg_len, reads.steps, reads.read_bounds,
                               reads.start, reads.end)
    np.testing.assert_array_equal(kind, got[0].numpy())
    hit = kind != port_gaf.KIND_NONE
    np.testing.assert_array_equal(a[hit], got[1].numpy()[hit])
    np.testing.assert_array_equal(b[hit], got[2].numpy()[hit])


def test_chunker_probe_forms_agree(monkeypatch, capsys):
    """probes/gaf_chunker.py: the shipped base step and the reference's
    running-max form give the same answer (on the CPU, host clock)."""
    from pollen_tpu_torch.probes import gaf_chunker

    for var, value in (("POLLEN_GAF_STEPS", "20000"), ("POLLEN_GAF_SEGS",
                       "1024"), ("POLLEN_GAF_READS", "700")):
        monkeypatch.setenv(var, value)
    assert gaf_chunker.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("exact=True") == 2, out


def test_absent_segment_name_is_the_reference_error(tmp_path, capsys):
    """An unknown name raises in the parse (never an out-of-range gather
    on the device): the library call, the CLI's exit and serve's error
    frame are the reference's."""
    g_ref, _, g, _ = both("small")
    bad = b"r\t14\t0\t14\t+\t>1>99\t7\t1\t6\t5\t5\t60\n"
    with pytest.raises(GFAParseError, match="unknown segment name"):
        port_gaf.parse_gaf(bad, g.seg_id_by_name())
    with pytest.raises(RefGFAParseError, match="unknown segment name"):
        ref_gaf.parse_gaf(bad, g_ref.seg_id_by_name())
    gfa = tmp_path / "small.gfa"
    gfa.write_bytes(SMALL_GFA)
    gaf = tmp_path / "bad.gaf"
    gaf.write_bytes(bad)
    for run, tool in ((port_run, "fgfa-torch"), (ref_run, "fgfa-tpu")):
        with pytest.raises(SystemExit) as exc:
            run(["-I", str(gfa), "gaf", str(gaf)])
        assert exc.value.code == 1
        assert capsys.readouterr().err == (
            f"{tool}: error: unknown segment name\n")
    text = f"gaf {gaf}\ngaf -b {gaf}\ndepth -d\n"
    got = port_run(["-I", str(gfa), "serve"], text)
    assert got == ref_run(["-I", str(gfa), "serve"], text)
    frames = [ln for ln in got.splitlines() if ln.startswith("##end")]
    assert frames == ["##end\terror\tunknown segment name"] * 2 + [
        "##end\tok"]


@pytest.mark.parametrize("name", ["small", "tiny.gfa", "rand1.gfa",
                                  "gen_rand_s3"])
def test_lookup_modes_match_reference(name):
    g_ref, dg_ref, g, dg = both(name)
    for data in read_sets(name, g):
        reads = port_gaf.parse_gaf(data, g.seg_id_by_name())
        ref_reads = ref_gaf.parse_gaf(data, g_ref.seg_id_by_name())
        for kw in ({}, {"seqs": True}, {"bench": True}):
            assert port_gaf.run_gaf_lookup(g, dg, reads, **kw) == (
                ref_gaf.run_gaf_lookup(g_ref, dg_ref, ref_reads, **kw)), kw


def test_stream_at_512_bytes_equals_the_whole(tmp_path):
    g_ref, dg_ref, g, dg = both("gen_rand_s3")
    path = tmp_path / "reads.gaf"
    path.write_bytes(synth_gaf(g, 300, seed=4, max_steps=12))
    assert path.stat().st_size > 8 * 512
    reads = port_gaf.parse_gaf_file(str(path), g)
    for kw in ({}, {"seqs": True}, {"bench": True}):
        whole = port_gaf.run_gaf_lookup(g, dg, reads, **kw)
        streamed = "".join(port_gaf.run_gaf_lookup_stream(
            g, dg, str(path), window_bytes=512, **kw))
        assert streamed == whole, kw
        assert streamed == "".join(ref_gaf.run_gaf_lookup_stream(
            g_ref, dg_ref, str(path), window_bytes=512, **kw)), kw


def test_parallel_windows_equal_serial(tmp_path):
    """The one spawn test: 2 worker processes parse the windows; the
    batches, in order, equal the serial parse's and the reference's."""
    _, _, g, _ = both("gen_rand_s0")
    path = tmp_path / "reads.gaf"
    path.write_bytes(synth_gaf(g, 120, seed=2, max_steps=8))
    names = g.seg_id_by_name()
    serial = list(port_gaf.iter_gaf_windows(str(path), names, 512, 1))
    par = list(port_gaf.iter_gaf_windows(str(path), names, 512, 2))
    assert len(serial) == len(par) > 2
    ref = ref_gaf._iter_gaf_blocks(str(path), 512)
    for a, b, block in zip(serial, par, ref):
        assert_reads_equal(b, a)
        assert_reads_equal(a, ref_gaf.parse_gaf(block, names))


def test_parse_workers_import_no_torch():
    """A spawned parse worker imports ``ops/gaf.py`` (and the package's
    ``__init__``) and nothing that reaches the device: no torch."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-c", "import sys; import pollen_tpu_torch.ops.gaf;"
         " assert 'torch' not in sys.modules, 'torch imported'"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_default_workers_and_small_files(tmp_path, monkeypatch):
    """POLLEN_GAF_WORKERS is the reference's knob; in auto mode a small
    file never starts the pool."""
    from unittest import mock

    monkeypatch.setenv("POLLEN_GAF_WORKERS", "3")
    assert port_gaf.default_gaf_workers() == 3
    monkeypatch.setenv("POLLEN_GAF_WORKERS", "0")
    assert port_gaf.default_gaf_workers() == 1
    monkeypatch.setenv("POLLEN_GAF_WORKERS", "4")
    _, _, g, _ = both("small")
    path = tmp_path / "one.gaf"
    path.write_bytes(EDGE_GAFS["reverse"])
    with mock.patch("concurrent.futures.ProcessPoolExecutor") as pool:
        out = list(port_gaf.iter_gaf_windows(str(path), g.seg_id_by_name()))
    assert pool.call_count == 0
    assert len(out) == 1 and out[0].num_reads == 2


@pytest.mark.parametrize("name", ["small", "rand1.gfa", "gen_rand_s3"])
def test_pangenotype_matrix_matches_reference(name, tmp_path):
    g_ref, _, g, _ = both(name)
    files = []
    for i, data in enumerate(read_sets(name, g)):
        path = tmp_path / f"s{i}.gaf"
        path.write_bytes(data)
        files.append(str(path))
    got = port_gaf.pangenotype_matrix(g, files, window_bytes=512, workers=1)
    want = ref_gaf.pangenotype_matrix(g_ref, files, window_bytes=512,
                                      workers=1)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert port_gaf.run_pangenotype(g, files) == ref_gaf.run_pangenotype(
        g_ref, files)


# ---------------------------------------------------------------------------
# The commands, through both CLIs
# ---------------------------------------------------------------------------


def gaf_commands(gafs):
    a, b = gafs
    return [
        ["gaf", a], ["gaf", "-s", a], ["gaf", "-b", a], ["gaf", "-p", b],
        ["gaf", "-b", "-p", b], ["matrix", a], ["matrix", a, b],
        ["pangenotype", b, a], ["pangenotype", a, a, b],
    ]


def fixture_gafs(stem, tmp):
    g = parse_gfa((GRAPH_DIR / f"{stem}.gfa").read_bytes())
    out = []
    for seed in (0, 1):
        path = tmp / f"{stem}.{seed}.gaf"
        path.write_bytes(synth_gaf(g, 40, seed=seed, max_steps=40))
        out.append(str(path))
    return out


@pytest.mark.parametrize("stem", [f[:-4] for f in FIXTURE_GRAPHS])
def test_gaf_commands_match_reference(stem, tmp_path):
    gfa = str(GRAPH_DIR / f"{stem}.gfa")
    for argv in gaf_commands(fixture_gafs(stem, tmp_path)):
        got = port_run(["-I", gfa, *argv])
        assert got and got == ref_run(["-I", gfa, *argv]), argv


def test_example_commands_and_serve_match_reference(tmp_path):
    gfa, gaf = str(EXAMPLE_GFA), str(EXAMPLE_GAF)
    for argv in gaf_commands([gaf, gaf]):
        assert port_run(["-I", gfa, *argv]) == ref_run(["-I", gfa, *argv])
    requests = [" ".join(argv) for argv in gaf_commands([gaf, gaf])]
    requests += ["depth -d", "gaf /no/such.gaf", "matrix"]
    text = "\n".join(requests) + "\n"
    got = port_run(["-I", gfa, "serve"], text)
    assert got == ref_run(["-I", gfa, "serve"], text)
    assert got.count("##end\tok\n") == len(requests) - 2
