"""The port's profiling utilities and entry point: ``stopwatch`` logs to
the ``pollen_tpu_torch`` logger, ``device_trace`` writes a Chrome trace
on the CPU (and waits its window margin only on a card), the trace-skew
probe pairs each event on the card with its launch, ``time_best``
returns a non-negative best time and synchronizes only on a card, and
``entry("cpu")``'s forward gives the reference ``entry()``'s depth and
unique depth on the same tiny graph, as does the routed
``masked_seg_depth`` on its index.
"""

import json
import logging

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from pollen_tpu_torch import profiling
from pollen_tpu_torch.entry import entry, tiny_arena
from pollen_tpu_torch.ops.depth import _best_masked_impl, masked_seg_depth
from pollen_tpu_torch.probes import trace_skew

torch.set_num_threads(1)


def test_stopwatch_logs(caplog):
    with caplog.at_level(logging.INFO, logger="pollen_tpu_torch"):
        with profiling.stopwatch("unit-test"):
            pass
    (record,) = [r for r in caplog.records if "unit-test" in r.message]
    assert record.name == "pollen_tpu_torch"
    assert record.message.endswith(" s")


def test_stopwatch_logs_when_the_block_raises(caplog):
    with caplog.at_level(logging.INFO, logger="pollen_tpu_torch"):
        with pytest.raises(ValueError):
            with profiling.stopwatch("failing-block"):
                raise ValueError("boom")
    assert any("failing-block" in r.message for r in caplog.records)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    forward, args = entry("cpu")
    log_dir = tmp_path / "traces"
    with profiling.device_trace(str(log_dir)):
        forward(*args)
    (trace,) = list(log_dir.iterdir())
    assert trace.name.endswith(".pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)
    # The block is the span pollen.trace_block: a reader cuts the
    # window's margins there. It holds the block's ops.
    (block,) = [e for e in events if e.get("name") == "pollen.trace_block"
                and e.get("ph") == "X"]
    assert block["cat"] in ("cpu_op", "user_annotation")
    lo, hi = block["ts"], block["ts"] + block["dur"]
    ops = [e for e in events if "cumsum" in str(e.get("name", ""))
           and e.get("cat") == "cpu_op"]
    assert ops and all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in ops)
    assert "pollen.trace_block" in [s.name for s in profiling.spans()]


def test_device_trace_writes_one_file_a_trace(tmp_path):
    for _ in range(2):
        with profiling.device_trace(str(tmp_path)):
            torch.ones(4).sum()
    assert len(list(tmp_path.iterdir())) == 2


def test_device_trace_waits_no_margin_on_the_cpu(tmp_path, monkeypatch):
    """The window's margin and the synchronizations are the card's: a
    trace on the CPU neither sleeps nor synchronizes."""
    calls = []
    monkeypatch.setattr(profiling.time, "sleep", calls.append)
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    with profiling.device_trace(str(tmp_path)):
        torch.ones(4).sum()
    assert calls == []
    assert profiling._TRACE_MARGIN_S > 0


@pytest.mark.parametrize("skew_us, kernels", [(12.5, 2), (-5334.1, 0)])
def test_trace_offsets_pair_events_with_their_launches(skew_us, kernels):
    """Each event on the card is paired with the runtime call of the same
    correlation. A device clock 5.3 ms behind the host's puts the two
    kernels before the window, which drops them: their launches still
    count, the late copy alone is kept."""
    events = [{"cat": "Trace", "ts": 0.0, "dur": 11478.3}]
    for corr, (name, ts) in enumerate([("cudaLaunchKernel", 1483.8),
                                       ("cudaLaunchKernel", 2055.5),
                                       ("cudaMemcpyAsync", 5560.8)]):
        events.append({"cat": "cuda_runtime", "name": name, "ts": ts,
                       "args": {"correlation": corr}})
        if ts + skew_us >= 0:  # the window keeps what starts inside it
            events.append({"cat": "kernel" if "Kernel" in name
                           else "gpu_memcpy", "name": f"op{corr}",
                           "ts": ts + skew_us, "args": {"correlation": corr}})
    got = trace_skew.offsets(events)
    assert got["launches"] == 2
    assert got["kernels"] == kernels
    assert got["min_us"] == pytest.approx(skew_us)
    assert got["max_us"] == pytest.approx(skew_us)
    assert trace_skew.offsets([])["min_us"] is None


def test_trace_skew_probe_runs_on_the_cpu():
    """The probe's traced child runs end to end in a process of its own;
    on the CPU its trace has no launches and no events on a card."""
    (row,) = trace_skew.run(1, 0, [0.0], (3000, 512, 8), device="cpu")
    assert row == {"run": 0, "margin_ms": 0.0, "launches": 0, "kernels": 0,
                   "min_us": None, "max_us": None}


def test_time_best_returns_a_time():
    forward, args = entry("cpu")
    t = profiling.time_best(forward, *args, reps=2)
    assert t >= 0 and np.isfinite(t)
    calls = []
    assert profiling.time_best(lambda: calls.append(1), reps=3, warmup=2) >= 0
    assert len(calls) == 5


def test_time_best_syncs_on_the_first_tensor(monkeypatch):
    """The first tensor of a nested result decides the device; a CPU
    tensor or a host result needs no synchronization."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    out = ({"a": [1, torch.zeros(2)]}, torch.ones(1))
    assert profiling._first_tensor(out) is out[0]["a"][1]
    assert profiling._first_tensor((1, "x", np.zeros(2))) is None
    profiling._sync(out)
    profiling._sync(None)
    assert synced == []


def test_entry_forward_equals_the_reference_entry():
    ref_fn, ref_args = ref_entry.entry()
    ref_depth, ref_uniq = (np.asarray(x) for x in ref_fn(*ref_args))
    forward, (dg, mask) = entry("cpu")
    depth, uniq = forward(dg, mask)
    assert depth.tolist() == ref_depth.tolist() == [2, 3, 1, 1]
    assert uniq.tolist() == ref_uniq.tolist() == [2, 2, 1, 1]
    assert dg.device == mask.device == torch.device("cpu")
    assert mask.dtype == torch.bool and mask.tolist() == [True, True]
    # The routed query on the same index (the crossing-matrix route at
    # this size) gives the same answer.
    assert _best_masked_impl(dg) == "cross"
    d_routed, u_routed = masked_seg_depth(dg, mask)
    assert d_routed.tolist() == [2, 3, 1, 1]
    assert u_routed.tolist() == [2, 2, 1, 1]


def test_entry_graph_is_the_reference_tiny_arena():
    ref = ref_entry._tiny_arena()
    port = tiny_arena()
    for name in ("seg_name", "seg_seq", "path_steps", "steps", "seq_data",
                 "link_from", "link_to", "name_data", "line_order"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name),
                                      err_msg=name)


def test_entry_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
