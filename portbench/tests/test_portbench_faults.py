"""A whole run on the CPU at a tiny size, its look for a card skipped:
sound, it comes out correct; with the timed path broken underneath, it
comes out not correct, once for each fault a cell can have. (One chip:
no exchange between chips to leave out.)"""

import numpy as np
import pytest

from conftest import tiny_config
from portbench import harness, registry


def stale(entry, g=None):
    """A call that returns its state unchanged: the previous answer."""
    last = []

    def call(dg, masks):
        out = entry(dg, masks)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return call


def half(entry, g=None):
    """Half of the batch left out and the rest's answers in its place;
    for one mask, half of its paths left out."""
    def call(dg, masks):
        m = np.array(masks)
        if m.ndim == 1:
            sel = np.flatnonzero(m)
            m[sel[: (sel.size + 1) // 2]] = False
            return entry(dg, m)
        keep = m.shape[0] // 2
        d, u = entry(dg, m[:keep])
        fill = np.arange(m.shape[0]) % keep
        return d[fill], u[fill]
    return call


def altered(entry, g=None):
    """An answer altered where it is produced: one depth off by one."""
    def call(dg, masks):
        d, u = entry(dg, masks)
        d = np.array(d)
        d.flat[d.size // 2] += 1
        return d, u
    return call


def raising(entry, g=None):
    def call(dg, masks):
        raise RuntimeError("launch failed")
    return call


CELLS = ["hprc_chr8.single", "hprc_chr8.batch32"]


def _run(cell, fault=None, seed=2**31 + 99, traced=False):
    w = registry.workload(cell)
    tr = registry.traffic(w["traffic"])
    tr.update(pool=64, check_calls=4, trace_calls=2)
    # A window long enough for several calls under load: a stale answer
    # shows only from the second call on.
    return harness.run_cell(cell, seed, 1.0, traced, "cpu",
                            config=tiny_config(w["config"]), traffic=tr,
                            fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    run, out = _run(cell)
    assert out["correct"], out["checks"]
    assert run.route == "cross"  # as at the real size
    assert run.answers_checked >= 1 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {m["name"] for m in registry.metrics(cell, "end_to_end")}


@pytest.mark.parametrize("cell", CELLS)
def test_request_time_is_recorded(cell):
    """The window's host time building requests, a stage, not a metric."""
    run, out = _run(cell)
    assert 0 < run.stages["requests_s"] < run.window_s
    assert "requests_s" not in out["metrics"]


@pytest.mark.parametrize("fault", [stale, half, altered, raising])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    run, out = _run(cell, fault)
    assert run.calls >= 2
    assert not out["correct"], (fault.__name__, out["checks"])


def test_traced_run_reports_layers():
    cell = "hprc_chr8.single"
    run, out = _run(cell, traced=True)
    assert out["correct"]
    assert "busy_s" in out["device"] and "breakdown" in out
    # No device activity on the CPU: the device shares read nothing.
    assert set(out["metrics"]) == {"ingest_s", "host_ms.single", "route_ms.single"}
    assert {"busy_s", "kernel_s", "copy_s"} <= set(run.trace)
