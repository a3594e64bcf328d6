"""Where the port's CUDA kernels are built from and into, checked on the
CPU (no nvcc needed): the package data ships csrc's sources, and the
build directory is the package's own ``_build`` when it can be written
(a checkout), else a per-user cache directory (an installed package in
a read-only site-packages)."""

import pathlib
import tomllib

from pollen_tpu_torch.kernels import _build

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_package_data_names_the_kernel_sources():
    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["pollen_tpu_torch"]
    assert set(globs) >= {"csrc/*.cu", "csrc/*.cuh"}
    pkg = REPO / "pollen_tpu_torch"
    shipped = {p for g in globs for p in pkg.glob(g)}
    assert shipped == set((pkg / "csrc").iterdir())  # every source file


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
