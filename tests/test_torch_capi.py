"""The port's C API (``pollen_tpu_torch/native``: ``capi.cpp``,
``pollen_capi.h``, ``example.c``): the cases of ``tests/test_capi.py``,
built from the port's copies, and the example's output against the one
built from the reference's sources, byte for byte."""

import pathlib
import shutil
import subprocess

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
NATIVE = REPO / "pollen_tpu_torch" / "native"
REF_NATIVE = REPO / "pollen_tpu" / "native"

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="C++ toolchain unavailable"
)


def build_example(src: pathlib.Path, d: pathlib.Path) -> pathlib.Path:
    """The C API library and its example program, from ``src``."""
    d.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [
            "g++", "-O2", "-shared", "-fPIC", "-pthread", "-std=c++17",
            "-o", str(d / "libpollen_capi.so"),
            str(src / "capi.cpp"), str(src / "gfa_scan.cpp"), "-I", str(src),
        ],
        check=True,
    )
    subprocess.run(
        [
            "g++", str(src / "example.c"), "-o", str(d / "example"),
            "-I", str(src), "-L", str(d), "-lpollen_capi",
            f"-Wl,-rpath,{d}",
        ],
        check=True,
    )
    return d / "example"


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    return build_example(NATIVE, tmp_path_factory.mktemp("capi_port"))


@pytest.fixture(scope="module")
def ref_example(tmp_path_factory):
    return build_example(REF_NATIVE, tmp_path_factory.mktemp("capi_ref"))


def test_capi_example(example):
    out = subprocess.run(
        [str(example), "tests/graphs/tiny.gfa"],
        capture_output=True,
        text=True,
        check=True,
        cwd=REPO,
    ).stdout
    assert "segments: 4" in out
    assert "seg 2: GATTACA" in out
    assert "paths: 2" in out
    assert "alpha: 0+ 1+ 2+" in out


def test_capi_parse_failure(example, tmp_path):
    bad = tmp_path / "bad.gfa"
    bad.write_text("X\tnope\n")
    result = subprocess.run(
        [str(example), str(bad)], capture_output=True, text=True
    )
    assert result.returncode == 1
    assert "parse failed" in result.stderr


@pytest.mark.parametrize(
    "graph", sorted(p.name for p in (REPO / "tests" / "graphs").glob("*.gfa"))
)
def test_capi_example_matches_the_reference(example, ref_example, graph):
    path = str(REPO / "tests" / "graphs" / graph)
    got = subprocess.run([str(example), path], capture_output=True, check=True)
    want = subprocess.run([str(ref_example), path], capture_output=True,
                          check=True)
    assert got.stdout == want.stdout
