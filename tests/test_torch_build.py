"""Where the port's CUDA kernels are built from and into, checked on the
CPU (no nvcc needed): the package data ships csrc's sources, and the
build directory is the package's own ``_build`` when it can be written
(a checkout), else a per-user cache directory (an installed package in
a read-only site-packages); and the ctypes signatures the library is
loaded with match the ``extern "C"`` prototypes of ``csrc/*.cu``."""

import ctypes
import pathlib
import re
import tomllib

import pytest

from pollen_tpu_torch.kernels import _build

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_package_data_names_the_kernel_sources():
    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["pollen_tpu_torch"]
    assert set(globs) >= {"csrc/*.cu", "csrc/*.cuh"}
    pkg = REPO / "pollen_tpu_torch"
    shipped = {p for g in globs for p in pkg.glob(g)}
    csrc = {p for p in shipped if p.parent == pkg / "csrc"}
    assert csrc == set((pkg / "csrc").iterdir())  # every source file


def test_package_data_names_the_native_sources():
    """The C++ scanner, the C API and its example ship, so an installed
    port can build them (the bridge is a module, shipped as code)."""
    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["pollen_tpu_torch"]
    pkg = REPO / "pollen_tpu_torch"
    shipped = {p for g in globs for p in pkg.glob(g)
               if p.parent == pkg / "native"}
    assert shipped == {p for p in (pkg / "native").iterdir()
                       if p.suffix in (".cpp", ".h", ".c")}
    assert {p.name for p in shipped} == {
        "gfa_scan.cpp", "capi.cpp", "pollen_capi.h", "example.c"}


def test_build_dir_is_the_package_dir_in_a_checkout():
    assert _build.build_dir() == _build.LOCAL_BUILD_DIR
    assert _build.library_path().parent == _build.LOCAL_BUILD_DIR


def test_build_dir_falls_back_to_the_user_cache(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_writable", lambda path: False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    got = _build.build_dir()
    assert got.parent == tmp_path / "xdg" / "pollen_tpu_torch"
    assert _build.library_path().parent == got
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    home = _build.build_dir()
    assert home.parent == tmp_path / "home" / ".cache" / "pollen_tpu_torch"
    assert home.name == got.name  # one directory per package path


def _c_type(decl: str):
    """The ctypes type of one C declaration (a parameter or a return)."""
    decl = decl.strip()
    if "*" in decl:
        return ctypes.c_void_p
    if decl.startswith("long long"):
        return ctypes.c_longlong
    if decl.startswith("int"):
        return ctypes.c_int
    raise ValueError(f"unexpected C declaration {decl!r}")


def _c_prototypes() -> dict:
    """{name: (return type, [parameter types])} of every entry point in
    the ``extern "C"`` blocks of csrc/*.cu."""
    out = {}
    for src in sorted((REPO / "pollen_tpu_torch" / "csrc").glob("*.cu")):
        text = src.read_text()
        block = re.sub(r"//[^\n]*", "", text[text.index('extern "C" {'):])
        for m in re.finditer(r"^(int|long long) (pollen_\w+)\(([^)]*)\)",
                             block, re.M):
            out[m.group(2)] = (_c_type(m.group(1)),
                               [_c_type(a) for a in m.group(3).split(",")])
    return out


def test_every_c_entry_point_has_a_signature():
    assert set(_c_prototypes()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_the_c_prototype(name):
    """A dropped or retyped argument would shift every later one."""
    restype, params = _c_prototypes()[name]
    assert list(_build.SIGNATURES[name]) == params
    assert _build.RESTYPES.get(name, ctypes.c_int) == restype
