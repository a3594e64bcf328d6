"""The port's spans and counters (``pollen_tpu_torch.profiling``: ``span``,
``recording``, ``count``) inside the depth queries and
``build_graph``, and the benchmark's readers of them (``portbench.spans``
and its per-layer metrics), on the CPU.

Off (no profiler, no ``recording()``) a span is one shared null context
and records nothing; under a ``torch.profiler`` session each span is an
event in the Chrome trace (``cpu_op``, or ``user_annotation`` through
``record_function`` where torch lacks the fast form), nested as in the program, and
in memory every span of one public call shares its call id. Answers are
the same, bit for bit, with recording on and off.
"""

import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pollen_tpu_torch import profiling
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.entry import tiny_arena
from pollen_tpu_torch.ops import depth
from pollen_tpu_torch.synth import synth_graph
from portbench import registry, spans, trace

torch.set_num_threads(1)

ENTRIES = {"single": depth.masked_seg_depth, "batch": depth.seg_depth_with_uniq_batch}
ROOT = {"single": "pollen.depth.single", "batch": "pollen.depth.batch"}
INGEST_STAGES = ("sort", "runs", "cross", "ell", "tables", "to_device")
# The cells of each entry, and the metrics that read the spans and counters.
CELLS = {"single": ["hprc_chr8.single", "chr8_ont_reads.single"],
         "batch": ["hprc_chr8.batch32", "chr8_ont_reads.batch32"]}
SPAN_METRICS = ("entry_ms", "launch_ms", "to_host_ms", "to_host_gbps")
INGEST_METRICS = tuple(f"ingest_{s}_s" for s in ("sort", "runs", "cross", "ell", "to_device"))


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def tiny():
    return build_graph(tiny_arena(), "cpu")


def _masks(dg, entry, q=3, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.random((q, dg.num_paths)) < 0.6
    m[:, 0] = True
    return m[0] if entry == "single" else m


# Graphs that take each route of the single entry (and of the batch's):
# the crossing matrix, the tiered ELL index, and the scan family.
ROUTES = {
    "cross": (lambda: tiny_arena(), None),
    "ell": (lambda: synth_graph(2**17, 2**16, 96), None),
    "scan": (lambda: synth_graph(2**14, 2**11, 96), "0"),
}


@pytest.fixture(scope="module")
def routed():
    import os

    out = {}
    for name, (make, budget) in ROUTES.items():
        old = os.environ.get("POLLEN_CROSS_BUDGET_MB")
        if budget is not None:
            os.environ["POLLEN_CROSS_BUDGET_MB"] = budget
        try:
            out[name] = build_graph(make(), "cpu")
        finally:
            if budget is not None:
                if old is None:
                    del os.environ["POLLEN_CROSS_BUDGET_MB"]
                else:
                    os.environ["POLLEN_CROSS_BUDGET_MB"] = old
    return out


def _by_call(recorded):
    calls = {}
    for s in recorded:
        calls.setdefault(s.call, []).append(s)
    return calls


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


@pytest.mark.parametrize("entry", ["span", "single", "batch"])
def test_off_records_nothing_and_shares_one_null_context(tiny, entry):
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("pollen.a"), profiling.span("pollen.b")
    assert a is b and isinstance(a, type(profiling._NULL))
    if entry == "span":
        with a, b:
            pass
    else:
        ENTRIES[entry](tiny, _masks(tiny, entry))
        assert profiling.counters()["depth.calls"] == 1  # counters stay on
    assert profiling.spans() == []


@pytest.mark.parametrize("event, cat", [("fast", "cpu_op"),
                                        ("record_function", "user_annotation")])
@pytest.mark.parametrize("entry", ["single", "batch"])
def test_profiler_exports_nested_span_events(tiny, entry, event, cat, tmp_path,
                                             monkeypatch):
    if event == "record_function":
        monkeypatch.setattr(profiling, "_event", torch.profiler.record_function)
    else:
        assert profiling._event is torch._C._profiler._RecordFunctionFast
    prof, _ = _profiled(lambda: ENTRIES[entry](tiny, _masks(tiny, entry)))
    ann = [e for e in _events(prof, tmp_path) if e.get("ph") == "X"
           and str(e.get("name")).startswith("pollen.")]
    assert {e["cat"] for e in ann} == {cat} and cat in trace.HOST_CATS
    names = [e["name"] for e in ann]
    (root,) = [e for e in ann if e["name"] == ROOT[entry]]
    kids = [e for e in ann if e["name"] != ROOT[entry]]
    assert sorted(names) == sorted([ROOT[entry], "pollen.depth.route",
                                    "pollen.depth.mask", "pollen.depth.device",
                                    "pollen.depth.to_host"])
    # In the call's order: the mask's upload, the router, the device
    # part, the copies.
    assert [k["name"] for k in sorted(kids, key=lambda e: e["ts"])] == [
        "pollen.depth.mask", "pollen.depth.route", "pollen.depth.device",
        "pollen.depth.to_host"]
    lo, hi = root["ts"], root["ts"] + root["dur"]
    for k in kids:
        assert lo <= k["ts"] and k["ts"] + k["dur"] <= hi, k["name"]


@pytest.mark.parametrize("mode", ["profiler", "recording"])
@pytest.mark.parametrize("entry", ["single", "batch"])
def test_spans_of_a_call_share_its_id_and_name_their_parent(tiny, entry, mode):
    def two_calls():
        for seed in range(2):
            ENTRIES[entry](tiny, _masks(tiny, entry, seed=seed))

    if mode == "profiler":
        _profiled(two_calls)
    else:
        with profiling.recording():
            two_calls()
    calls = _by_call(profiling.spans())
    assert len(calls) == 2
    for call, got in calls.items():
        by_id = {s.id: s for s in got}
        (root,) = [s for s in got if s.parent is None]
        assert root.name == ROOT[entry] and root.id == call
        for s in got:
            assert s.call == call and s.start_ns <= s.end_ns
            if s is not root:
                assert by_id[s.parent] is root
                assert root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
        assert len(got) == 5


@pytest.mark.parametrize("entry, q", [("single", 1), ("batch", 1), ("batch", 3)])
def test_counters_a_call(tiny, entry, q):
    masks = _masks(tiny, entry, q=q)
    ENTRIES[entry](tiny, masks)
    n = tiny.num_segments
    assert profiling.counters() == {"depth.calls": 1, "depth.to_host_bytes": 8 * n * q}
    # A mask already on the graph's device counts the same.
    ENTRIES[entry](tiny, torch.from_numpy(masks))
    assert profiling.counters() == {"depth.calls": 2, "depth.to_host_bytes": 16 * n * q}


def test_build_graph_counts_every_stage():
    import time

    g = synth_graph(2**15, 2**12, 40)
    t0 = time.perf_counter()
    build_graph(g, "cpu")
    wall = time.perf_counter() - t0
    c = profiling.counters()
    assert set(c) == {"ingest.builds"} | {f"ingest.{s}.s" for s in INGEST_STAGES}
    stages = [c[f"ingest.{s}.s"] for s in INGEST_STAGES]
    assert all(v > 0 for v in stages)
    assert sum(stages) <= wall
    assert c["ingest.builds"] == 1
    assert profiling.spans() == []  # stage seconds count with spans off


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_build_graph_spans_nest_under_ingest(mode):
    g = synth_graph(2**13, 2**10, 16)
    if mode == "profiler":
        _profiled(lambda: build_graph(g, "cpu"))
    else:
        with profiling.recording():
            build_graph(g, "cpu")
    got = profiling.spans()
    (root,) = [s for s in got if s.parent is None]
    assert root.name == "pollen.ingest"
    assert sorted(s.name for s in got if s.parent == root.id) == sorted(
        f"pollen.ingest.{s}" for s in INGEST_STAGES)


def test_buffer_drops_the_oldest():
    extra = 5
    with profiling.recording():
        for i in range(profiling.SPAN_BUFFER + extra):
            with profiling.span("s"):
                pass
    got = profiling.spans()
    assert len(got) == profiling.SPAN_BUFFER
    ids = [s.id for s in got]
    assert ids == sorted(ids) and ids[-1] - ids[0] == profiling.SPAN_BUFFER - 1


def test_threads_count_and_nest_their_own_spans():
    """More threads than cores, switching often: no counter update is
    lost, and each thread's spans nest under its own root."""
    import os
    import sys
    import threading

    n_threads, n = 2 * (os.cpu_count() or 4), 300
    old = sys.getswitchinterval()

    def work(k):
        for _ in range(n):
            with profiling.span(f"pollen.root.{k}"):
                profiling.count("t")
                with profiling.span(f"pollen.child.{k}"):
                    profiling.count("t")

    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counters()["t"] == 2 * n * n_threads
    got = profiling.spans()
    by_id = {s.id: s for s in got}
    assert len(got) == 2 * n * n_threads
    for s in got:
        if s.name.startswith("pollen.child."):
            root = by_id[s.parent]
            assert root.name == "pollen.root." + s.name.rsplit(".", 1)[1]
            assert s.call == root.id == root.call


def test_stage_counts_seconds_with_spans_off():
    from pollen_tpu_torch.device import _stage

    with _stage("t"):
        pass
    with _stage("t"):
        pass
    assert profiling.counters()["ingest.t.s"] >= 0 and profiling.spans() == []
    with profiling.recording():
        with _stage("t"):
            pass
    assert [s.name for s in profiling.spans()] == ["pollen.ingest.t"]
    profiling.reset()
    with pytest.raises(ValueError):
        with profiling.recording():
            with profiling.span("pollen.raises"):
                raise ValueError("boom")
    assert [s.name for s in profiling.spans()] == ["pollen.raises"]
    assert profiling._local.stack == []


FALLBACK = "inside the call, outside torch ops (host numpy)"


@pytest.mark.parametrize("entry", ["single", "batch"])
def test_trace_reading_names_in_call_gaps_by_program_spans(tiny, entry, tmp_path):
    """The harness's traced calls on the CPU, each torch op standing in
    for device work: the host time between ops inside the program's
    calls, which the trace reading named by its fallback label (as it
    still does with the program's events taken out of the trace), is
    named by the program's spans."""
    reqs = [_masks(tiny, entry, seed=seed) for seed in range(4)]

    def calls():
        ENTRIES[entry](tiny, reqs[0])  # the profiler's first events
        with record_function(trace.WINDOW):
            for masks in reqs:
                with record_function(trace.CALL):
                    ENTRIES[entry](tiny, masks)

    prof, _ = _profiled(calls)
    events = _events(prof, tmp_path)
    events += [dict(e, cat="kernel") for e in events
               if e.get("cat") == "cpu_op" and e.get("ph") == "X"
               and str(e.get("name")).startswith("aten::")]
    with_spans = dict(trace.reading(events)["idle_gaps"])
    without = dict(trace.reading(
        [e for e in events if not str(e.get("name")).startswith("pollen.")]
    )["idle_gaps"])
    named = sum(v for k, v in with_spans.items() if k.startswith("pollen.depth."))
    assert named > 0 and not any(k.startswith("pollen.") for k in without)
    assert set(with_spans) <= {"harness, between calls", FALLBACK} | {
        k for k in with_spans if k.startswith("pollen.depth.")}
    assert without[FALLBACK] == pytest.approx(with_spans.get(FALLBACK, 0.0) + named)


def _run(entry, traced=True, device="cuda"):
    """A run as the readers see it: the program's spans and counters are
    this process's, recorded on the CPU; the run says it ran on the card,
    where the readers read."""
    return types.SimpleNamespace(entry=entry, traced=traced,
                                 device=torch.device(device),
                                 traffic={"trace_calls": 2})


@pytest.mark.parametrize("metric", [f"{m}.{e}" for m in SPAN_METRICS
                                    for e in ("single", "batch")] + list(INGEST_METRICS))
def test_metric_readers(tiny, metric):
    """Each new reader is named in BENCHMARK.json, reads a number from
    its entry's traced calls on the card, and None off its cell,
    untraced, and in a run on the CPU."""
    named = {m["name"]: m for m in registry.benchmark()["per_layer"]}
    assert metric in named
    read = registry.reader(metric)
    build_graph(tiny_arena(), "cpu")
    for entry in ("single", "batch"):
        _profiled(lambda: [ENTRIES[entry](tiny, _masks(tiny, entry, seed=s))
                           for s in range(2)])
    if metric.startswith("ingest_"):
        assert "workloads" not in named[metric]
        assert read(_run("single")) > 0 and read(_run("batch")) > 0
        assert read(_run("single", traced=False)) is None
        assert read(_run("single", device="cpu")) is None
        return
    entry = metric.rsplit(".", 1)[1]
    other = "batch" if entry == "single" else "single"
    assert named[metric]["workloads"] == CELLS[entry]
    assert read(_run(entry)) > 0
    assert read(_run(other)) is None
    assert read(_run(entry, traced=False)) is None
    assert read(_run(entry, device="cpu")) is None


def test_readers_of_a_program_without_spans(tiny, monkeypatch):
    """Over a program whose profiling has no spans or counters (the
    parent of this change), every reader finds nothing and raises
    nothing."""
    monkeypatch.delattr(profiling, "spans")
    for name in [f"{m}.single" for m in SPAN_METRICS] + list(INGEST_METRICS):
        assert registry.reader(name)(_run("single")) is None
    assert spans.counters() == {}


def test_entry_metrics_add_up(tiny):
    """entry_ms is the root less its device and copy children; the
    children cover most of each profiled call."""
    _profiled(lambda: [ENTRIES["single"](tiny, _masks(tiny, "single", seed=s))
                       for s in range(2)])
    got = spans.calls(_run("single"), "single")
    assert len(got) == 2
    for c in got:
        assert set(c["children"]) == {"pollen.depth.route", "pollen.depth.mask",
                                       "pollen.depth.device", "pollen.depth.to_host"}
        assert sum(c["children"].values()) <= c["root"]
    run = _run("single")
    assert spans.entry_ms(run, "single") + spans.launch_ms(
        run, "single") + spans.to_host_ms(run, "single") == pytest.approx(
        1e3 * sum(c["root"] for c in got) / 2)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("entry", ["single", "batch"])
def test_answers_unchanged_with_recording_on(routed, route, entry):
    dg = routed[route]
    want = depth.masked_route_fn(dg)[0] if entry == "single" else depth.batch_route_fn(dg)[0]
    assert want == route or (route == "scan" and entry == "batch" and want == "runs")
    masks = _masks(dg, entry)
    off = ENTRIES[entry](dg, masks)
    with profiling.recording():
        on = ENTRIES[entry](dg, masks)
    _, prof_on = _profiled(lambda: ENTRIES[entry](dg, masks))
    for got in (on, prof_on):
        for a, b in zip(off, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("entry", ["single", "batch"])
def test_a_call_opens_few_spans_and_counts(routed, route, entry, monkeypatch):
    """At most 10 spans and 10 counter updates a public call, on every
    route; a call's copies are one span (under compose on the ELL
    route)."""
    dg = routed[route]
    updates = []
    count = profiling.count
    monkeypatch.setattr(profiling, "count",
                        lambda name, n=1: (updates.append(name), count(name, n)))
    with profiling.recording():
        ENTRIES[entry](dg, _masks(dg, entry))
    got = profiling.spans()
    assert len(got) <= 10 and len(updates) <= 10
    by_id = {s.id: s for s in got}
    (copy,) = [s for s in got if s.name == "pollen.depth.to_host"]
    parent = "pollen.depth.compose" if route == "ell" else ROOT[entry]
    assert by_id[copy.parent].name == parent
    # The answers' bytes; on the ELL route the class parts (never-crossed
    # segments hold none) and the order.
    n, q = dg.num_segments, 1 if entry == "single" else 3
    got_bytes = profiling.counters()["depth.to_host_bytes"]
    assert got_bytes > 0 if route == "ell" else got_bytes == 8 * n * q


def test_span_costs_under_a_microsecond_off():
    import time

    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("pollen.x"):
            pass
    # Generous against a loaded machine: the check itself is ~0.4 us.
    assert (time.perf_counter() - t0) / n < 5e-6
