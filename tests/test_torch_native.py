"""The port's native layer (``pollen_tpu_torch.native``: the C++ GFA
scanner, its emitter and the direct converter) against the JAX
package's (``pollen_tpu.native``) and the NumPy parsers, on the same
inputs. Every case of ``tests/test_native.py`` runs on the port's
library; the arrays are compared field by field and the bytes exactly
(tolerance 0 throughout). The port builds its own library, under its
own name, outside the package's sources; ``POLLEN_NATIVE=0`` takes the
NumPy path with the same bytes.
"""

import dataclasses
import io
import shutil

import numpy as np
import pytest

from conftest import FIXTURE_GRAPHS, GRAPH_DIR, REPO
from graphgen import big_step_graph, random_graph
from pollen_tpu import native as ref_native
from pollen_tpu.emit import emit_gfa as ref_emit_gfa
from pollen_tpu.fileformat import save_flatgfa as ref_save_flatgfa
from pollen_tpu.flatgfa import parse_gfa as ref_parse_gfa
from pollen_tpu_torch import cli
from pollen_tpu_torch import native
from pollen_tpu_torch.emit import emit_gfa, emit_gfa_to_file
from pollen_tpu_torch.fileformat import save_flatgfa
from pollen_tpu_torch.kernels._build import LOCAL_BUILD_DIR, build_dir
from pollen_tpu_torch.flatgfa import parse_gfa
from pollen_tpu_torch.native import convert_gfa_native, parse_gfa_native

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="C++ toolchain unavailable"
)


def assert_same(a, b):
    assert b is not None
    for f in dataclasses.fields(a):
        va = np.asarray(getattr(a, f.name))
        vb = np.asarray(getattr(b, f.name))
        assert va.shape == vb.shape, f.name
        assert (va == vb).all(), f.name


GENERATED = {
    "random0": lambda: random_graph(seed=0, n_segs=30, n_paths=5),
    "random1": lambda: random_graph(seed=1, n_segs=30, n_paths=5),
    "random2": lambda: random_graph(seed=2, n_segs=30, n_paths=5),
    "overlap_col": lambda: random_graph(
        seed=9, n_segs=64, n_paths=12, with_overlap_col=True
    ),
    "big_step": lambda: big_step_graph(500, 20_000, 8, seed=2),
}


def case_bytes(case: str) -> bytes:
    if case in GENERATED:
        return GENERATED[case]().encode()
    return (GRAPH_DIR / case).read_bytes()


CASES = FIXTURE_GRAPHS + sorted(GENERATED)


# -- the cases of tests/test_native.py, on the port's library -------------


def test_fixture_parity(graph_path):
    data = graph_path.read_bytes()
    assert_same(parse_gfa(data, native=False), parse_gfa_native(data))


def test_random_parity():
    for seed in range(3):
        text = random_graph(seed=seed, n_segs=30, n_paths=5).encode()
        assert_same(parse_gfa(text, native=False), parse_gfa_native(text))
    text = big_step_graph(500, 20_000, 8, seed=2).encode()
    assert_same(parse_gfa(text, native=False), parse_gfa_native(text))


def test_overlap_columns_parity():
    text = (
        b"H\tVN:Z:1.0\nS\t1\tAA\nS\t2\tCC\n"
        b"P\tp\t1+,2-\t2M,1M1D\nP\tq\t2+\t*\n"
        b"L\t1\t+\t2\t-\t3M2N\nL\t2\t+\t1\t+\t*\n"
    )
    assert_same(parse_gfa(text, native=False), parse_gfa_native(text))


def test_out_of_order_parity():
    text = b"L\t2\t+\t1\t-\t0M\nP\tp\t2+,1+\t*\nS\t1\tAA\nS\t2\tCC\n"
    assert_same(parse_gfa(text, native=False), parse_gfa_native(text))


def test_sparse_names_parity():
    text = b"S\t10\tAA\nS\t3\tCC\nS\t99\tGG\nP\tp\t99+,10-,3+\t*\n"
    assert_same(parse_gfa(text, native=False), parse_gfa_native(text))


def test_emit_to_file_matches_emit(tmp_path, graph_path, monkeypatch):
    """The direct-to-file native emit == emit_gfa == the input bytes."""
    monkeypatch.setenv("POLLEN_SCAN_THREADS", "3")
    data = graph_path.read_bytes()
    g = parse_gfa(data)
    out = tmp_path / "o.gfa"
    emit_gfa_to_file(g, str(out))
    assert out.read_bytes() == data
    assert emit_gfa(g, order="preserved").encode() == data


def test_multithreaded_shards_identical(monkeypatch):
    """The sharded parallel parse must be byte-identical to one shard,
    including CIGAR pools (link-then-path order) and sparse names."""
    texts = [
        big_step_graph(400, 30_000, 7, seed=5).encode(),
        random_graph(
            seed=9, n_segs=64, n_paths=12, with_overlap_col=True
        ).encode(),
        # Sparse names force the hash-map path across shards.
        b"S\t10\tAA\nS\t3\tCC\nS\t99\tGG\n"
        b"P\tp\t99+,10-,3+\t*\nL\t10\t+\t3\t-\t2M\n",
    ]
    for text in texts:
        monkeypatch.setenv("POLLEN_SCAN_THREADS", "1")
        ref = parse_gfa_native(text)
        for nt in ("2", "3", "13"):
            monkeypatch.setenv("POLLEN_SCAN_THREADS", nt)
            assert_same(ref, parse_gfa_native(text))


@pytest.mark.parametrize("spare", [0.0, 0.5])
def test_convert_direct_to_file(tmp_path, graph_path, spare):
    """gfa_convert writes a file byte-identical to parse + save_flatgfa."""
    data = graph_path.read_bytes()
    native_out = tmp_path / "native.flatgfa"
    assert convert_gfa_native(data, str(native_out), spare)
    py_out = tmp_path / "python.flatgfa"
    save_flatgfa(str(py_out), parse_gfa(data, native=False), spare=spare)
    assert native_out.read_bytes() == py_out.read_bytes()


def test_convert_rejects_fall_back(tmp_path):
    out = tmp_path / "x.flatgfa"
    assert not convert_gfa_native(b"X\twat\n", str(out))
    assert not out.exists()


def test_convert_write_failure_raises(tmp_path):
    with pytest.raises(OSError):
        convert_gfa_native(b"S\t1\tAA\n", str(tmp_path / "no/dir/x.fgfa"))


def test_native_rejects_fall_back():
    # Unknown line kinds are a scanner error -> None (caller falls back
    # to the NumPy parser for the real diagnostics).
    assert parse_gfa_native(b"X\twat\n") is None
    assert parse_gfa_native(b"S\tabc\tAA\n") is None  # non-integer name


# -- the port against the reference ---------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_arrays_equal_the_references(case):
    """The port's native arrays equal the reference's native scanner's
    and the reference's NumPy parser's."""
    data = case_bytes(case)
    got = parse_gfa_native(data)
    assert_same(ref_parse_gfa(data, native=False), got)
    if ref_native.native_available():
        assert_same(ref_native.parse_gfa_native(data), got)
    assert_same(got, parse_gfa(data))  # the default path is the native one


@pytest.mark.parametrize("case", CASES)
def test_emit_and_convert_bytes_equal_the_references(case, tmp_path):
    data = case_bytes(case)
    g = parse_gfa(data)
    text = native.emit_gfa_native(g)
    assert text == ref_emit_gfa(ref_parse_gfa(data), order="preserved")
    assert text.encode() == data
    out = tmp_path / "o.gfa"
    assert native.emit_gfa_file_native(g, str(out))
    assert out.read_bytes() == data
    for spare in (0.0, 0.5):
        port_out, ref_out = tmp_path / "port.fgfa", tmp_path / "ref.fgfa"
        assert convert_gfa_native(data, str(port_out), spare)
        ref_save_flatgfa(
            str(ref_out), ref_parse_gfa(data, native=False), spare=spare
        )
        assert port_out.read_bytes() == ref_out.read_bytes()


@pytest.mark.parametrize("case", CASES)
def test_pollen_native_0_takes_the_numpy_path(case, tmp_path, monkeypatch):
    """Under POLLEN_NATIVE=0 no native call runs, and the parse, the
    emit, the file emit and ``-I x.gfa -o y.flatgfa`` give the bytes of
    the native path."""
    data = case_bytes(case)
    gfa = tmp_path / "in.gfa"
    gfa.write_bytes(data)
    results = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("POLLEN_NATIVE", flag)
        assert native.native_available() == (flag == "1")
        g = parse_gfa(data)
        out_gfa = tmp_path / f"out{flag}.gfa"
        emit_gfa_to_file(g, str(out_gfa))
        out_fgfa = tmp_path / f"out{flag}.flatgfa"
        cli.main(["--device", "cpu", "-I", str(gfa), "-o", str(out_fgfa)],
                 stdout=io.StringIO())
        results[flag] = (g, emit_gfa(g), out_gfa.read_bytes(),
                         out_fgfa.read_bytes())
    monkeypatch.setenv("POLLEN_NATIVE", "0")
    assert parse_gfa_native(data) is None
    assert native.emit_gfa_native(results["0"][0]) is None
    assert not convert_gfa_native(data, str(tmp_path / "never.fgfa"))
    assert not (tmp_path / "never.fgfa").exists()
    assert_same(results["1"][0], results["0"][0])
    assert results["1"][1:] == results["0"][1:]
    assert results["0"][1].encode() == data


def test_cli_converts_through_the_native_pass(tmp_path, monkeypatch):
    """``-I x.gfa -o y.flatgfa`` goes through convert_gfa_native where
    the library is built (and writes what parse + save writes)."""
    calls = []
    real = native.convert_gfa_native

    def spy(data, out_path, spare=0.0):
        calls.append(spare)
        return real(data, out_path, spare)

    monkeypatch.setattr(native, "convert_gfa_native", spy)
    out = tmp_path / "t.flatgfa"
    cli.main(["--device", "cpu", "-I", str(GRAPH_DIR / "tiny.gfa"), "-o",
              str(out), "--prealloc-factor", "0.5"], stdout=io.StringIO())
    assert calls == [0.5]
    ref = tmp_path / "ref.flatgfa"
    ref_save_flatgfa(str(ref), ref_parse_gfa((GRAPH_DIR / "tiny.gfa")
                                             .read_bytes()), spare=0.5)
    assert out.read_bytes() == ref.read_bytes()


def test_library_is_the_ports_own_and_outside_the_sources():
    """Built from the port's copy into the ignored build directory (or
    the cache), under a name of its own: never the reference's .so."""
    assert native.native_available()
    so = native.library_path()
    assert so.exists()
    assert so.name.startswith("libpollen_scan_torch-") and so.suffix == ".so"
    assert so.parent == build_dir()
    assert so.parent not in (REPO / "pollen_tpu_torch" / "native",
                             REPO / "pollen_tpu" / "native")
    if so.parent == LOCAL_BUILD_DIR:  # a checkout: git ignores the build
        ignored = (REPO / ".gitignore").read_text().splitlines()
        assert "pollen_tpu_torch/_build/" in ignored
    loaded = native._lib._name
    assert loaded == str(so)
    assert "pollen_tpu/native" not in loaded
    # The sources the port builds are byte copies of the reference's.
    for name in ("gfa_scan.cpp", "capi.cpp", "pollen_capi.h", "example.c"):
        assert (REPO / "pollen_tpu_torch" / "native" / name).read_bytes() == (
            REPO / "pollen_tpu" / "native" / name
        ).read_bytes(), name


def test_build_failure_falls_back_with_the_message(tmp_path, monkeypatch):
    """A failed compile leaves the native path off, with g++'s message,
    and the parse still answers through NumPy."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(
        native, "library_path", lambda: tmp_path / "build" / "libx.so"
    )
    assert not native.native_available()
    assert "g++ failed" in native.build_error
    data = (GRAPH_DIR / "tiny.gfa").read_bytes()
    assert_same(ref_parse_gfa(data, native=False), parse_gfa(data))
    assert not (tmp_path / "build" / "libx.so").exists()
    assert list((tmp_path / "build").iterdir()) == []
