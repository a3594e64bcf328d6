"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root names each cell's configuration and traffic mix; the configuration
is ``configs/<name>.json``, the mix ``traffic/<name>.json`` and each
metric's reader ``metrics/<name>.py`` (a function ``read(run)`` that
returns the metric's value, or None where it finds nothing to read).
A configuration names its graph's shape (key ``shape``), drawn by
``shapes/<shape>.py``, and a mix its kind of subset mask (key
``subsets``), drawn by ``subsets/<subsets>.py``; ``README.md`` gives
each module's interface. A new cell, configuration, mix, shape, subset
kind or metric is new files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

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


def _module(folder: str, name: str):
    """``<folder>/<name>.py``, loaded by its path (a name may hold dots)
    once a process: a later lookup returns the same module."""
    key = f"portbench_{folder}_{name}"
    if key not in sys.modules:
        path = HERE / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[key] = module
    return sys.modules[key]


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    return _module("metrics", name).read


def shape(name: str):
    """``shapes/<name>.py``: ``draw(cfg, seed, device)`` gives (arena,
    groups), ``sizes(cfg)`` the (segments, steps) it draws."""
    return _module("shapes", name)


def subsets(name: str):
    """``subsets/<name>.py``: ``streams(traffic, n_paths, groups, seed,
    device)`` gives (the window's request stream, the warm-up's)."""
    return _module("subsets", name)
