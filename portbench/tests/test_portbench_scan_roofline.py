"""The readers of ``seg_scan_roofline`` and ``run_scan_roofline``: the
least time of a pass (16 bytes an element at 3.35 TB/s) over the traced
time a pass, from the trace's kernel by name and the program's scan
counters (stubbed here); None without the kernel, without the counters
(a program before them), untraced and off the card; declared for the
reads cells alone."""

import types

import pytest
import torch

from portbench import registry, scan_roofline, spans

METRICS = {"seg_scan_roofline": ("SegScanOp", "chr8_ont_reads.single", "query_p95_ms"),
           "run_scan_roofline": ("RunScanOp", "chr8_ont_reads.batch32", "queries_per_s")}
# A pass of 2^27 elements moves 2 GiB: 641 us at 3.35 TB/s.
ELEMENTS = 1 << 27
LEAST_S = 16 * ELEMENTS / 3.35e12


def _run(ops, calls=4, traced=True, device="cuda"):
    return types.SimpleNamespace(
        traced=traced, device=torch.device(device),
        trace={"calls": calls, "device_ops": ops} if traced else None)


@pytest.fixture
def stub(monkeypatch):
    def set_counters(c):
        monkeypatch.setattr(spans, "counters", lambda: dict(c))
    return set_counters


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_declared_for_its_reads_cell(metric):
    (m,) = [m for m in registry.benchmark()["per_layer"] if m["name"] == metric]
    op, cell, moves = METRICS[metric]
    assert m["workloads"] == [cell] and m["moves"] == moves
    assert (m["unit"], m["better"], m["source"], m["layer"]) == (
        "%", "higher", "device_trace", "CUDA kernels")


@pytest.mark.parametrize("per_call", [1, 32])
@pytest.mark.parametrize("metric", sorted(METRICS))
def test_share_a_pass(stub, metric, per_call):
    op = METRICS[metric][0]
    read = registry.reader(metric)
    calls = 1000
    stub({"depth.calls": calls, "depth.scan_passes": calls * per_call,
          "depth.scan_elements": calls * per_call * ELEMENTS})
    # Four traced calls, each pass at twice its least time.
    name = f"void (anonymous namespace)::scan_single<(anonymous namespace)::{op}>(x)"
    ops = [["Memcpy DtoH (Device -> Pinned)", 1.0], [name, 4 * per_call * 2 * LEAST_S]]
    assert read(_run(ops)) == pytest.approx(50.0)
    other = "RunScanOp" if op == "SegScanOp" else "SegScanOp"
    assert read(_run([[name.replace(op, other), 1e-3]])) is None


@pytest.mark.parametrize("counters", [
    {},  # a program without the scan counters (the parent of this change)
    {"depth.calls": 10},
    {"depth.calls": 10, "depth.scan_passes": 10},
    {"depth.scan_passes": 10, "depth.scan_elements": 100},
])
def test_none_without_the_counters(stub, counters):
    stub(counters)
    assert scan_roofline.roofline_pct(_run([["SegScanOp", 1e-3]]), "SegScanOp") is None


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_none_untraced_and_off_the_card(stub, metric):
    op = METRICS[metric][0]
    stub({"depth.calls": 1, "depth.scan_passes": 1, "depth.scan_elements": ELEMENTS})
    read = registry.reader(metric)
    assert read(_run([[op, 1e-3]], traced=False)) is None
    assert read(_run([[op, 1e-3]], device="cpu")) is None
    assert read(_run([[op, 1e-3]], calls=0)) is None
