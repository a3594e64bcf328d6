"""The reader of ``route_replay_hit.single``: None untraced, off the
card, off the single entry's cells and over a program without the
counters; on the card, the share computed from the counters (stubbed
here)."""

import types

import pytest
import torch

from portbench import registry, replay, spans

CELLS = ["hprc_chr8.single", "chr8_ont_reads.single"]


def _run(entry="single", traced=True, device="cuda"):
    return types.SimpleNamespace(entry=entry, traced=traced,
                                 device=torch.device(device))


@pytest.fixture
def stub(monkeypatch):
    def set_counters(c):
        monkeypatch.setattr(spans, "counters", lambda: dict(c))
    return set_counters


def test_declared_for_the_single_cells():
    (m,) = [m for m in registry.benchmark()["per_layer"]
            if m["name"] == "route_replay_hit.single"]
    assert m["workloads"] == CELLS
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "%", "higher", "program_counter", "route device part", "query_p95_ms")


@pytest.mark.parametrize("counters, share", [
    ({"depth.route_parts": 400, "depth.route_graphs": 1,
      "depth.route_replays": 398}, 99.5),
    # A key whose capture failed: every later call eager, none replayed.
    ({"depth.route_parts": 50, "depth.route_uncaptured": 49}, 0.0),
    # Keys evicted or never reused: parts without replays read as misses.
    ({"depth.route_parts": 50, "depth.route_graphs": 10,
      "depth.route_replays": 5}, 10.0),
])
def test_share_from_counters_on_the_card(stub, counters, share):
    stub(counters)
    assert registry.reader("route_replay_hit.single")(_run()) == pytest.approx(share)


def test_none_untraced_off_the_card_and_off_its_cells(stub):
    read = registry.reader("route_replay_hit.single")
    stub({"depth.route_parts": 400, "depth.route_replays": 398})
    assert read(_run(traced=False)) is None
    assert read(_run(device="cpu")) is None
    assert read(_run(entry="batch")) is None


@pytest.mark.parametrize("counters", [
    {},  # an older program, without the counters
    {"depth.route_parts": 0},
    {"depth.route_replays": 1},
    {"depth.to_host_pinned": 400, "host.pinned_blocks_created": 6},
])
def test_none_without_parts(stub, counters):
    stub(counters)
    assert replay.hit_share(_run()) is None
