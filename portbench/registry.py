"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root names each cell's configuration and traffic mix; the configuration
is ``configs/<name>.json``, the mix ``traffic/<name>.json`` and each
metric's reader ``metrics/<name>.py`` (a function ``read(run)`` that
returns the metric's value, or None where it finds nothing to read).
A new cell, configuration, mix or metric is new files and entries;
nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(name: str, bench: dict | None = None) -> dict:
    return _by_name((bench or benchmark())["workloads"], name, "workload")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def metrics(cell: str, kind: str, bench: dict | None = None) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell``
    reports: those with no ``workloads`` key and those that list it."""
    return [m for m in (bench or benchmark())[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """``metrics/<name>.py``'s ``read`` (the name may hold dots, so the
    file is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
