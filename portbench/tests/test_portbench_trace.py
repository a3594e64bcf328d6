"""The trace reading, the roofline and the idle share on a synthetic
trace."""

import types

import numpy as np
import pytest
import torch

from portbench import layers, roofline, trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# A window of 1000 us with two calls; on the device a kernel (100-150),
# a copy overlapping it (140-240) and a kernel in the second call
# (600-650); the host spends 250-560 in the first call outside torch.
EVENTS = [
    _x("user_annotation", trace.WINDOW, 100.0, 1000.0),
    _x("user_annotation", trace.CALL, 100.0, 500.0),
    _x("user_annotation", trace.CALL, 600.0, 480.0),
    _x("cpu_op", "aten::copy_", 140.0, 105.0),
    _x("cuda_runtime", "cudaLaunchKernel", 590.0, 5.0),
    _x("kernel", "ell_splitn_kernel", 100.0, 50.0),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 140.0, 100.0),
    _x("kernel", "boundary_diff_kernel", 600.0, 50.0),
    _x("gpu_user_annotation", trace.CALL, 100.0, 500.0),
    {"ph": "i", "cat": "kernel", "name": "not a span", "ts": 0.0},
]


def test_reading():
    r = trace.reading(EVENTS)
    assert r["busy_s"] == pytest.approx(190e-6)  # 100-240 and 600-650
    assert r["kernel_s"] == pytest.approx(100e-6)
    assert r["copy_s"] == pytest.approx(100e-6)
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["device_ops"][0] == ["Memcpy DtoH (Device -> Pageable)", pytest.approx(100e-6)]
    assert len(r["device_ops"]) == 3
    gaps = dict(r["idle_gaps"])
    # 240-600: the first call's host work (midpoint 420); 650-1100: the
    # second call's (midpoint 875).
    assert gaps == {"inside the call, outside torch ops (host numpy)":
                    pytest.approx(810e-6)}
    assert sum(gaps.values()) + r["busy_s"] == pytest.approx(r["window_s"])


def test_reading_without_window():
    assert trace.reading([_x("kernel", "k", 0.0, 1.0)]) is None


def test_merge():
    spans = [(5, 7, "a"), (0, 2, "b"), (1, 3, "c"), (3, 4, "d")]
    assert trace.merge(spans) == [(0, 4), (5, 7)]


def _run(entry, q, busy_s=190e-6, kernel_s=100e-6, calls=2):
    return types.SimpleNamespace(
        entry=entry, traced=True, masks_per_call=q,
        public_s=[0.010, 0.012], route_s=[0.001, 0.003],
        call_bytes=1_008_100, config={"paths": 100}, n_segments=1000,
        trace={"busy_s": busy_s, "kernel_s": kernel_s, "copy_s": 90e-6,
               "window_s": 1000e-6, "calls": calls})


def test_roofline_and_idle():
    run = _run("single", 1)
    least = 1_008_100 / 3.35e12
    # Over the kernels' time alone: 100 us for two calls.
    assert layers.roofline_pct(run, "single") == pytest.approx(100 * least / 50e-6)
    assert layers.copy_ms(run, "single") == pytest.approx(0.045)
    assert layers.device_idle_pct(run, "single") == pytest.approx(81.0)
    assert layers.host_ms(run, "single") == pytest.approx(9.0)
    assert layers.route_ms(run, "single") == pytest.approx(2.0)
    # The other entry's metrics find nothing to read in this run.
    for fn in (layers.roofline_pct, layers.device_idle_pct, layers.host_ms,
               layers.route_ms, layers.copy_ms):
        assert fn(run, "batch") is None


def test_no_device_time_reads_nothing():
    run = _run("batch", 32, busy_s=0.0)
    assert layers.roofline_pct(run, "batch") is None
    assert layers.device_idle_pct(run, "batch") is None
    # Copies but no kernel: no roofline to read.
    assert layers.roofline_pct(_run("batch", 32, kernel_s=0.0), "batch") is None


def _graph(rows=8, n_pad=100, nibble=True):
    return types.SimpleNamespace(
        num_segments=90, cross_nibble=nibble,
        cross_matrix=torch.zeros((rows, n_pad), dtype=torch.uint8),
        cross_res=torch.zeros((16, 3), dtype=torch.int32),
        cross_res_seg=torch.zeros(3, dtype=torch.int32))


def test_call_bytes_counts_the_selected_rows():
    """Of the crossing matrix, the rows holding a selected path (a nibble
    row holds paths 2r and 2r + 1); the residual whole; the masks and
    the answers."""
    dg = _graph()
    m = np.zeros(12, bool)
    m[[0, 1, 5]] = True  # rows 0 and 2
    res = 16 * 3 * 4 + 3 * 4
    assert roofline.call_bytes(dg, "cross", m) == 2 * 100 + res + 12 + 8 * 90
    two = np.stack([m, np.roll(m, 6)])  # rows 0, 2, 3, 5
    assert roofline.call_bytes(dg, "cross", two) == 4 * 100 + res + 24 + 2 * 8 * 90
    assert roofline.call_bytes(dg, "cross", np.zeros(12, bool)) == res + 12 + 8 * 90
    assert roofline.selected_rows(m, 16, 1) == 3
    assert roofline.selected_rows(np.ones(12, bool), 8, 2) == 6  # rows 6, 7 pad
