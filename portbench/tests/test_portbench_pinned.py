"""The readers of ``to_host_pinned_hit.single`` and ``.batch``: None
untraced, off the card, off their entry's cell and over a program
without the counters; on the card, the share computed from the
counters (stubbed here)."""

import types

import pytest
import torch

from portbench import pinned, registry, spans

CELLS = {"single": "hprc_chr8.single", "batch": "hprc_chr8.batch32"}


def _run(entry, traced=True, device="cuda"):
    return types.SimpleNamespace(entry=entry, traced=traced,
                                 device=torch.device(device))


@pytest.fixture
def stub(monkeypatch):
    def set_counters(c):
        monkeypatch.setattr(spans, "counters", lambda: dict(c))
    return set_counters


@pytest.mark.parametrize("entry", sorted(CELLS))
def test_declared_for_its_own_cell(entry):
    (m,) = [m for m in registry.benchmark()["per_layer"]
            if m["name"] == f"to_host_pinned_hit.{entry}"]
    assert m["workloads"] == [CELLS[entry]]
    assert (m["unit"], m["better"], m["layer"]) == ("%", "higher", "query entry")
    assert m["moves"] == ("query_p95_ms" if entry == "single" else "queries_per_s")


@pytest.mark.parametrize("entry", sorted(CELLS))
def test_share_from_counters_on_the_card(stub, entry):
    read = registry.reader(f"to_host_pinned_hit.{entry}")
    stub({"depth.to_host_pinned": 400, "host.pinned_blocks_created": 6})
    assert read(_run(entry)) == pytest.approx(98.5)
    stub({"depth.to_host_pinned": 8, "host.pinned_blocks_created": 0})
    assert read(_run(entry)) == 100.0


@pytest.mark.parametrize("entry", sorted(CELLS))
def test_none_untraced_off_the_card_and_off_its_cell(stub, entry):
    read = registry.reader(f"to_host_pinned_hit.{entry}")
    stub({"depth.to_host_pinned": 400, "host.pinned_blocks_created": 6})
    other = "batch" if entry == "single" else "single"
    assert read(_run(entry, traced=False)) is None
    assert read(_run(entry, device="cpu")) is None
    assert read(_run(other)) is None


@pytest.mark.parametrize("counters", [
    {},  # a program without the counters (the parent of this change)
    {"depth.to_host_pinned": 400},  # CUDA never initialised
    {"depth.to_host_pinned": 0, "host.pinned_blocks_created": 0},
    {"host.pinned_blocks_created": 3},
])
def test_none_without_both_counters(stub, counters):
    stub(counters)
    assert pinned.hit_share(_run("single"), "single") is None

