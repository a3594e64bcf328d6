"""The single routed depth query's device parts replayed from CUDA
graphs captured once per graph, route, mask shape and dtype
(``ops.depth._route_part``); the batch's run eagerly.

On the CPU: the entries and the route fns capture nothing and count
none of the ``depth.route_*`` counters, two calls of a route fn return
tensors that share no storage, and ``plain=True`` runs eagerly; every
answer equals a plain numpy count of the selected paths' visits (the
other ``test_torch_*`` files hold the routes to the JAX reference).

On the card (marker ``card``; they skip inside the test without one):
consecutive entry calls with different masks equal the plain path and
the numpy count, and answers held from the first calls do not change;
each call adds the eager path's scan counters, and each launch is a
wrapper's or a replay's; one capture a key, and none for a batch; a
route fn under an outer capture runs eagerly.
The card's machine has no JAX, which ``tests/conftest.py`` imports, so
run them there without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_route_replay.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pollen_tpu_torch import profiling
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.kernels import runscan, segscan
from pollen_tpu_torch.ops import depth
from pollen_tpu_torch.synth import synth_graph

torch.set_num_threads(1)

NEW = ("depth.route_parts", "depth.route_graphs", "depth.route_replays",
       "depth.route_uncaptured")
# The single route each build takes; its batch takes "cross" and "runs".
BUILDS = {"cross": "auto", "scan": "never"}
ENTRIES = {"single": (depth.masked_seg_depth, depth.masked_route_fn),
           "batch": (depth.seg_depth_with_uniq_batch, depth.batch_route_fn)}
SITES = 300
HAPLOTYPES = 24
CALLS = 8
Q = 5


def chain_graph(seed=3):
    """HAPLOTYPES walks of a chain of SITES bubbles as paths: a backbone
    segment, then one of two allele segments, or every tenth site a loop
    of 1-20 copies of a third (counts past a nibble: the crossing
    matrix's clip residual)."""
    rng = np.random.default_rng(seed)
    walks = []
    for _ in range(HAPLOTYPES):
        w = []
        for s in range(SITES):
            w.append(3 * s)
            if s % 10 == 9:
                w += [3 * s + 2] * int(rng.integers(1, 21))
            else:
                w.append(3 * s + 1 + int(rng.integers(0, 2)))
        walks.append(np.array(w, np.int64))
    lens = np.array([w.size for w in walks])
    ends = np.cumsum(lens).astype(np.uint32)
    return dataclasses.replace(
        synth_graph(1, 3 * SITES, HAPLOTYPES),
        steps=(np.concatenate(walks) << 1).astype(np.uint32),
        path_steps=np.stack([ends - lens.astype(np.uint32), ends], axis=1))


G = chain_graph()


def counts(masks):
    """(depth, uniq) int64[Q, N] of the selected paths: their visits,
    and their distinct (path, segment) pairs, by segment."""
    n = G.num_segments
    seg = (G.steps >> 1).astype(np.int64)
    path = G.step_path_ids().astype(np.int64)
    d, u = [], []
    for m in np.atleast_2d(masks):
        sel = m[path]
        d.append(np.bincount(seg[sel], minlength=n))
        pairs = np.unique(path[sel] * n + seg[sel])
        u.append(np.bincount(pairs % n, minlength=n))
    return np.stack(d), np.stack(u)


def masks_of(entry, call, q=Q):
    rng = np.random.default_rng(call)
    m = rng.random((q, HAPLOTYPES)) < rng.uniform(0.2, 0.9)
    m[:, call % HAPLOTYPES] = True
    return m[0] if entry == "single" else m


def same(got, want, entry):
    got = [np.asarray(torch.as_tensor(x).cpu()) for x in got]
    if entry == "single":
        want = [w[0] for w in want]
    return all(np.array_equal(x, w) for x, w in zip(got, want))


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def cpu_graphs():
    return {r: build_graph(G, "cpu", cross_matrix=b) for r, b in BUILDS.items()}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_graphs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return lambda route: build_graph(G, "cuda", cross_matrix=BUILDS[route])


@pytest.mark.parametrize("route", sorted(BUILDS))
def test_cpu_captures_and_counts_nothing(cpu_graphs, route):
    dg = cpu_graphs[route]
    assert depth.masked_route_fn(dg)[0] == route
    for entry, (call, route_fn) in ENTRIES.items():
        for c in range(3):
            m = masks_of(entry, c)
            assert same(call(dg, m), counts(m), entry)
            assert same(route_fn(dg)[1](dg, m), counts(m), entry)
    assert dg.route_parts == {}
    assert not set(NEW) & set(profiling.counters())


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("route", sorted(BUILDS))
def test_cpu_route_fn_calls_share_no_storage(cpu_graphs, route, entry):
    dg = cpu_graphs[route]
    fn = ENTRIES[entry][1](dg)[1]
    first = fn(dg, masks_of(entry, 1))
    kept = [x.clone() for x in first]
    second = fn(dg, masks_of(entry, 2))
    for a, b in zip(first, second):
        assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    assert all(torch.equal(a, k) for a, k in zip(first, kept))
    assert same(first, counts(masks_of(entry, 1)), entry)
    assert same(second, counts(masks_of(entry, 2)), entry)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.card)])
@pytest.mark.parametrize("route", sorted(BUILDS))
def test_plain_runs_eagerly(route, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    dg = build_graph(G, device, cross_matrix=BUILDS[route])
    for entry, (_, route_fn) in ENTRIES.items():
        fn = route_fn(dg)[1]
        for c in range(3):
            m = masks_of(entry, c)
            assert same(fn(dg, torch.from_numpy(m).to(device), plain=True),
                        counts(m), entry)
    assert dg.route_parts == {}
    assert not set(NEW) & set(profiling.counters())


@pytest.mark.card
@pytest.mark.parametrize("route", sorted(BUILDS))
def test_card_calls_equal_plain_and_hold_answers(card, card_graphs, route):
    dg = card_graphs(route)
    assert depth.masked_route_fn(dg)[0] == route
    for entry, (call, route_fn) in ENTRIES.items():
        fn = route_fn(dg)[1]
        held = []
        for c in range(CALLS):
            m = masks_of(entry, c)
            got = call(dg, m)
            plain = fn(dg, torch.from_numpy(m).to(card), plain=True)
            assert all(np.array_equal(a, b.cpu()) for a, b in zip(got, plain)), (entry, c)
            held.append(got)
        for c, got in enumerate(held):
            assert same(got, counts(masks_of(entry, c)), entry), (entry, c)
    c = profiling.counters()
    # The single query's calls only: its first eager, its second captured.
    assert c["depth.route_parts"] == CALLS
    assert c["depth.route_graphs"] == 1
    assert c["depth.route_replays"] == CALLS - 2
    assert len(dg.route_parts) == 1


@pytest.mark.card
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_card_scan_counts_a_call_equal_eager(card, card_graphs, entry):
    """Each call, eager, captured or replayed, adds what an eager call
    does: a pass a mask, its padded elements, and a launch of K6 or K8,
    by its wrapper where the wrapper runs, else by a replay."""
    dg = card_graphs("scan")
    call = ENTRIES[entry][0]
    launches, key, elements = (
        (runscan.launches, "run_scan", dg.run_path.shape[0]) if entry == "batch"
        else (segscan.launches, "seg_scan", dg.padded_steps))
    passes = Q if entry == "batch" else 1

    def tally():
        c = profiling.counters()
        return (c.get("depth.scan_passes", 0), c.get("depth.scan_elements", 0),
                launches[key], c.get("depth.route_replays", 0))

    for c in range(4):
        before = tally()
        call(dg, masks_of(entry, c))
        got = [a - b for a, b in zip(tally(), before)]
        replayed = entry == "single" and c >= 2
        assert got == [passes, passes * elements, 0 if replayed else passes,
                       int(replayed)], (c, got)
    assert profiling.counters().get("depth.route_graphs", 0) == (entry == "single")


@pytest.mark.card
def test_card_batch_captures_nothing(card, card_graphs):
    dg = card_graphs("cross")
    fn = depth.batch_route_fn(dg)[1]
    outs = []
    for q in (32, 5, 32):
        m = masks_of("batch", q, q)
        outs.append((fn(dg, torch.from_numpy(m).to(card)), m))
    for got, m in outs:
        assert same(got, counts(m), "batch")
    first, third = outs[0][0], outs[2][0]
    for a, b in zip(first, third):
        assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    assert dg.route_parts == {}
    assert not set(NEW) & set(profiling.counters())


@pytest.mark.card
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_card_outer_capture_runs_eagerly(card, card_graphs, entry):
    warm = card_graphs("cross")  # the kernels' first calls, on another graph
    depth.masked_seg_depth(warm, masks_of("single", 0))
    depth.seg_depth_with_uniq_batch(warm, masks_of("batch", 0))
    dg = card_graphs("cross")
    fn = ENTRIES[entry][1](dg)[1]
    m = masks_of(entry, 5)
    mt = torch.from_numpy(m).to(card)
    before = profiling.counters().get("depth.route_parts", 0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(dg, mt)
    graph.replay()
    torch.cuda.synchronize()
    assert same(out, counts(m), entry)
    assert dg.route_parts == {}
    assert profiling.counters().get("depth.route_parts", 0) == before
