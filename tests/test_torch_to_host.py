"""The depth entries' host answers (``ops.depth._to_host``), on the CPU:
answers held across later calls keep their values, arrays of two calls
never share memory, each is writable host int32, and a CPU process
counts no page-locked buffer. On every route a CPU graph reaches (the
crossing matrix, the tiered ELL index, the scan family), against the
JAX reference's plain masked query (exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pollen_tpu.device import build_device_graph
from pollen_tpu.ops import depth as ref_depth
from pollen_tpu_torch import profiling
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.entry import tiny_arena
from pollen_tpu_torch.ops import depth
from pollen_tpu_torch.synth import synth_graph

torch.set_num_threads(1)

ENTRIES = {"single": depth.masked_seg_depth, "batch": depth.seg_depth_with_uniq_batch}
# Graphs that take each route (batch: "runs" where the single query
# takes "scan"), with the crossing-matrix budget each is built under.
ROUTES = {
    "cross": (tiny_arena, None),
    "ell": (lambda: synth_graph(2**17, 2**16, 96), None),
    "scan": (lambda: synth_graph(2**14, 2**11, 96), "0"),
}
CALLS = 4  # the first call's answers are held through three more


@pytest.fixture(scope="module")
def routed():
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, (make, budget) in ROUTES.items():
            g = make()
            with mp.context() as m:
                if budget is not None:
                    m.setenv("POLLEN_CROSS_BUDGET_MB", budget)
                out[name] = (build_graph(g, "cpu"), build_device_graph(g, device="host"))
    finally:
        mp.undo()
    return out


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    yield
    profiling.reset()


def _masks(p, entry, call):
    rng = np.random.default_rng(call)
    m = rng.random((3, p)) < rng.uniform(0.2, 0.9)
    m[0, call % p] = True
    return m[0] if entry == "single" else m


def _reference(ref_dg, masks):
    rows = [ref_depth.seg_depth_with_uniq_masked(ref_dg, jnp.asarray(m))
            for m in np.atleast_2d(masks)]
    d, u = (np.stack([np.asarray(r[k]) for r in rows]) for k in (0, 1))
    return (d[0], u[0]) if masks.ndim == 1 else (d, u)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_answers_held_across_later_calls(routed, route, entry):
    dg, ref_dg = routed[route]
    want = (depth.masked_route_fn(dg)[0] if entry == "single"
            else depth.batch_route_fn(dg)[0])
    assert want == route or (route == "scan" and entry == "batch" and want == "runs")
    masks = [_masks(dg.num_paths, entry, c) for c in range(CALLS)]
    outs = [ENTRIES[entry](dg, m) for m in masks]
    for m, out in zip(masks, outs):
        for got, ref in zip(out, _reference(ref_dg, m)):
            assert isinstance(got, np.ndarray) and got.dtype == np.int32
            assert got.flags.writeable
            assert np.array_equal(got, ref)
    # Arrays of two calls never share memory; nor do a call's two.
    flat = [a for out in outs for a in out]
    for i, a in enumerate(flat):
        for b in flat[i + 1:]:
            assert not np.shares_memory(a, b)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_a_cpu_process_counts_no_pinned_buffer(routed, route, entry):
    dg, _ = routed[route]
    ENTRIES[entry](dg, _masks(dg.num_paths, entry, 0))
    c = profiling.counters()
    assert c["depth.calls"] == 1
    assert "depth.to_host_pinned" not in c
    assert "host.pinned_blocks_created" not in c
    assert not torch.cuda.is_initialized()


def test_pinned_copies_fall_back_where_page_locking_fails(monkeypatch):
    """Where the host allocator raises, nothing is copied or counted, and
    the caller takes the pageable copy."""
    def refuse(*args, **kwargs):
        raise RuntimeError("no page-locked memory")

    parts = [torch.arange(6, dtype=torch.int32), torch.ones((2, 3), dtype=torch.int32)]
    monkeypatch.setattr(torch, "empty", refuse)
    assert depth._pinned_copies(parts) is None
    assert "depth.to_host_pinned" not in profiling.counters()


def test_to_host_keeps_none_and_counts_bytes():
    a = torch.arange(5, dtype=torch.int32)
    out = depth._to_host(a, None)
    assert out[1] is None and np.array_equal(out[0], np.arange(5))
    assert profiling.counters() == {"depth.to_host_bytes": 20}
