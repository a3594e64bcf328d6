"""The package metadata reaches the port: every console script named in
``pyproject.toml`` resolves to a function, and every ``*-torch`` script
is covered by an optional extra that installs torch (``pip install
.[torch]``). The file is read with ``tomllib``.
"""

import importlib
import re
import tomllib

import pytest

from conftest import REPO

with open(REPO / "pyproject.toml", "rb") as f:
    PYPROJECT = tomllib.load(f)
PROJECT = PYPROJECT["project"]
SCRIPTS = PROJECT["scripts"]
TORCH_SCRIPTS = sorted(name for name in SCRIPTS if name.endswith("-torch"))


def requirement_name(req: str) -> str:
    """The distribution a PEP 508 requirement names."""
    return re.split(r"[\s\[<>=!~;@(]", req.strip(), maxsplit=1)[0].lower()


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_script_target_resolves(script):
    module, _, attr = SCRIPTS[script].partition(":")
    assert module and attr, SCRIPTS[script]
    fn = importlib.import_module(module)
    for part in attr.split("."):
        fn = getattr(fn, part)
    assert callable(fn)


def test_port_scripts_are_declared():
    assert TORCH_SCRIPTS == ["exine-torch", "fgfa-torch", "flash-torch",
                             "pollen-spec-torch"]


@pytest.mark.parametrize("script", TORCH_SCRIPTS)
def test_port_script_has_a_torch_extra(script):
    package = SCRIPTS[script].partition(":")[0].split(".")[0]
    assert package == "pollen_tpu_torch"
    extras = PROJECT.get("optional-dependencies", {})
    assert "torch" not in {requirement_name(r) for r in PROJECT["dependencies"]}
    covering = [name for name, reqs in extras.items()
                if "torch" in {requirement_name(r) for r in reqs}]
    assert covering == ["torch"], extras


def test_port_package_is_found_and_ships_its_sources():
    setuptools = PYPROJECT["tool"]["setuptools"]
    include = setuptools["packages"]["find"]["include"]
    assert any(re.fullmatch(p.replace("*", ".*"), "pollen_tpu_torch")
               for p in include)
    assert "csrc/*.cu" in setuptools["package-data"]["pollen_tpu_torch"]
