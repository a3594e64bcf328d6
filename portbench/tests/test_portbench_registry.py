"""Every configuration, traffic mix and metric reader is a file of its
own that the harness finds by the name in BENCHMARK.json, and every
such file is named there."""

import ast
import json
import re

import pytest

from portbench import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_named_file_is_found():
    for c in BENCH["configs"]:
        cfg = registry.config(c["name"])
        assert cfg["name"] == c["name"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert (registry.ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert registry.workload(w["name"]) == w
        assert registry.config(w["config"])
        tr = registry.traffic(w["traffic"])
        assert tr["name"] == w["traffic"] and tr["entry"] in ("single", "batch")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.reader(m["name"]))


def test_every_file_is_named():
    names = {d: {p.stem for p in (registry.HERE / d).glob("*.json")}
             for d in ("configs", "traffic")}
    assert names["configs"] == {c["name"] for c in BENCH["configs"]}
    assert names["traffic"] == {w["traffic"] for w in BENCH["workloads"]}
    readers = {p.name[:-3] for p in (registry.HERE / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}


def test_every_shape_and_subset_kind_is_found():
    for c in BENCH["configs"]:
        name = registry.config(c["name"])["shape"]
        assert (registry.HERE / "shapes" / f"{name}.py").is_file()
        shape = registry.shape(name)
        assert callable(shape.draw) and callable(shape.sizes)
    for w in BENCH["workloads"]:
        name = registry.traffic(w["traffic"])["subsets"]
        assert (registry.HERE / "subsets" / f"{name}.py").is_file()
        assert callable(registry.subsets(name).streams)


def test_every_shape_and_subset_file_is_named():
    shapes = {p.stem for p in (registry.HERE / "shapes").glob("*.py")}
    assert shapes == {registry.config(c["name"])["shape"] for c in BENCH["configs"]}
    kinds = {p.stem for p in (registry.HERE / "subsets").glob("*.py")}
    assert kinds == {registry.traffic(w["traffic"])["subsets"] for w in BENCH["workloads"]}


def test_no_code_names_a_shape_or_kind():
    """Only the registry's lookup by the files' keys reaches a shape or
    a subset kind: no source outside the tests holds one's name as a
    string, so none branches on it."""
    names = ({p.stem for p in (registry.HERE / "shapes").glob("*.py")}
             | {p.stem for p in (registry.HERE / "subsets").glob("*.py")})
    for path in registry.HERE.rglob("*.py"):
        if "tests" in path.relative_to(registry.HERE).parts:
            continue
        strings = {n.value for n in ast.walk(ast.parse(path.read_text()))
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        assert not strings & names, path


def test_names_and_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    every = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in every:
        assert NAME.match(e["name"]), e["name"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for cell in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in registry.metrics(cell, "end_to_end")}
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_and_a_layer(cell):
    e2e = {m["name"] for m in registry.metrics(cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.metrics(cell, "per_layer")
