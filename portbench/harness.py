"""One run of one cell.

1. Set-up: the arena, drawn by the configuration's shape, and the
   request streams, drawn by the traffic's subset kind, on the device
   from the seed (``registry.shape``, ``registry.subsets``); the path
   count is the arena's. Then the program's ingest (``build_graph``
   with its defaults), and warm-up calls of the cell's own entry and
   shapes on masks the window never sends.
2. The window: a closed loop with one client for ``seconds``. Each call
   builds the next request's masks (numpy bool, as library users pass
   them; the time spent building them is the stage ``requests_s``),
   sends them to the public entry and holds the host arrays it returns;
   its latency runs from the call to the arrays in hand. A seeded
   sample of the answers is held aside (``Sample``).
3. With ``trace``: the first ``trace_calls`` requests again, each as the
   public call and as the route's device part (host clock, ending in a
   synchronise), then the same public calls under ``torch.profiler``.
4. The device's peak memory is read, the program's state freed, and the
   sampled answers compared with the plain reference (``reference``).

``run_cell`` returns the ``Run`` record that the metric readers read,
and the result line's object.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.ops import depth as depth_op

from . import generate, host, reference, registry, roofline, trace

# The public entries the traffic mixes name, each with the router that
# gives its route and the route's device part.
ENTRIES = {
    "single": (depth_op.masked_seg_depth, depth_op.masked_route_fn),
    "batch": (depth_op.seg_depth_with_uniq_batch, depth_op.batch_route_fn),
}
MARGIN_S = 0.05
# Masks the reference answers at once in the check.
CHECK_BLOCK = 32
FORBIDDEN = ("jax", "jaxlib", "flax", "pollen_tpu")


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    setup_s: float = 0.0
    ingest_s: float = 0.0
    window_s: float = 0.0
    latencies_s: list = dataclasses.field(default_factory=list)
    calls: int = 0
    attempted: int = 0
    answered: int = 0
    failed: int = 0
    route: str = ""
    n_segments: int = 0
    call_bytes: float = 0.0
    public_s: list = dataclasses.field(default_factory=list)
    route_s: list = dataclasses.field(default_factory=list)
    trace: dict | None = None
    memory_peak_bytes: int = 0
    answers_checked: int = 0
    checks: dict = dataclasses.field(default_factory=dict)
    stages: dict = dataclasses.field(default_factory=dict)
    host: dict = dataclasses.field(default_factory=dict)

    @property
    def entry(self) -> str:
        return self.traffic["entry"]

    @property
    def masks_per_call(self) -> int:
        return self.traffic["masks_per_call"]


class Sample:
    """A uniform sample of the window's calls, drawn from the seed
    (algorithm R over the calls answered), and of each call kept,
    ``rows`` of its answers (drawn from the seed), held as the entry
    returned them."""

    def __init__(self, calls: int, rows: int, q: int, rng: np.random.Generator):
        self.calls, self.rows, self.q, self.rng = calls, min(rows, q), q, rng
        self.kept = []  # per slot: (call, rows, [(depth row, uniq row)])
        self.seen = 0

    def offer(self, call: int, out) -> None:
        self.seen += 1
        slot = len(self.kept)
        if slot >= self.calls:
            slot = int(self.rng.integers(0, self.seen))
            if slot >= self.calls:
                return
        else:
            self.kept.append(None)
        rows = sorted(int(j) for j in self.rng.choice(self.q, self.rows, replace=False))
        got = [[_row(arr, j, self.q) for arr in out] for j in rows]
        self.kept[slot] = (call, rows, got)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _request(stream, call: int, q: int, entry: str):
    """Call ``call``'s masks from the subset kind's ``stream``: one (P,)
    mask for the single entry, else (q, P); requests are numbered mask
    by mask."""
    if entry == "single":
        return stream.mask(call)
    return stream.masks(call * q, q)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([generate.seed64(seed), stream])


def setup(run: Run):
    """The arena, the ingest and the warm-up; returns (arena, graph,
    the window's mask stream)."""
    cfg, tr, dev = run.config, run.traffic, run.device
    q = run.masks_per_call
    t0 = time.perf_counter()
    g, groups = registry.shape(cfg["shape"]).draw(cfg, run.seed, dev)
    stream, warm = registry.subsets(tr["subsets"]).streams(
        tr, len(g.path_steps), groups, run.seed, dev)
    _sync(dev)
    run.stages["inputs_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    dg = build_graph(g, dev)
    _sync(dev)
    run.ingest_s = time.perf_counter() - t0
    entry, route_fn = ENTRIES[run.entry]
    run.route = route_fn(dg)[0]
    run.n_segments = g.num_segments
    t0 = time.perf_counter()
    for c in range(tr["warmup_calls"]):
        masks = _request(warm, c, q, run.entry)
        entry(dg, masks)
        if run.traced:
            route_fn(dg)[1](dg, masks)
    _sync(dev)
    run.stages["warmup_s"] = time.perf_counter() - t0
    return g, dg, stream


def window(run: Run, entry, dg, stream, sample: Sample) -> None:
    """The measured closed loop; a call that raises counts its masks as
    failed (the first traceback goes to standard error). The host time
    spent building requests, before each call's clock starts, adds up
    to the stage ``requests_s``."""
    q = run.masks_per_call
    host_before = host.reading()
    requests_s = 0.0
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    c = 0
    while (r := time.perf_counter()) < deadline:
        masks = _request(stream, c, q, run.entry)
        run.attempted += q
        a = time.perf_counter()
        requests_s += a - r
        try:
            out = entry(dg, masks)
        except Exception:  # a failed call is counted, and the loop goes on
            if not run.failed:
                traceback.print_exc()
            run.failed += q
            out = None
        b = time.perf_counter()
        if out is not None:
            run.latencies_s.append(b - a)
            run.answered += q
            sample.offer(c, out)
        c += 1
    run.window_s = time.perf_counter() - t0
    run.stages["requests_s"] = requests_s
    run.calls = c
    run.host = host.after(host_before, c)


def traced_calls(run: Run, entry, route_fn, dg, stream) -> None:
    """The per-layer readings: the public call and the route's device
    part on the same masks, then the public calls under the profiler."""
    dev, q = run.device, run.masks_per_call
    reqs = [_request(stream, j, q, run.entry) for j in range(run.traffic["trace_calls"])]
    run.call_bytes = sum(roofline.call_bytes(dg, run.route, m) for m in reqs) / len(reqs)
    fn = route_fn(dg)[1]
    for masks in reqs:
        a = time.perf_counter()
        entry(dg, masks)
        b = time.perf_counter()
        fn(dg, masks)
        _sync(dev)
        run.public_s.append(b - a)
        run.route_s.append(time.perf_counter() - b)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
        with profile(activities=acts) as prof:
            _sync(dev)
            time.sleep(MARGIN_S)
            with record_function(trace.WINDOW):
                for masks in reqs:
                    with record_function(trace.CALL):
                        entry(dg, masks)
                _sync(dev)
            time.sleep(MARGIN_S)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        run.trace = trace.reading(trace.load(path))
    if run.trace is not None:
        run.trace["calls"] = len(reqs)


def _row(arr, j: int, q: int) -> np.ndarray:
    """Row ``j`` of an answer of a call of ``q`` masks: the answer itself
    for one mask, else its row ``j`` (empty where it is not (q, N))."""
    arr = np.asarray(arr)
    if q == 1 and arr.ndim == 1:
        return arr
    return arr[j] if arr.ndim == 2 and arr.shape[0] == q else np.zeros(0)


def check(run: Run, g, stream, sample: Sample) -> None:
    """The sampled answers against the reference; ``run.checks`` holds
    each number compared beside its limit. An answer of the wrong shape
    differs in every element."""
    ref = reference.Reference(g.steps, g.path_steps, g.num_segments)
    q = run.masks_per_call
    diff = {"depth": 0, "uniq": 0}
    kept = [(c * q + j, got) for c, rows, gots in sorted(sample.kept, key=lambda x: x[0])
            for j, got in zip(rows, gots)]
    for lo in range(0, len(kept), CHECK_BLOCK):
        block = kept[lo : lo + CHECK_BLOCK]
        depth, uniq = ref.answers(np.stack([stream.mask(i) for i, _ in block]))
        for r, (_, (d, u)) in enumerate(block):
            got = reference.differences(d, u, (depth[r], uniq[r]))
            for k in diff:
                diff[k] += got[k]
    run.checks = {
        "depth_diff": {"value": diff["depth"], "limit": 0},
        "uniq_diff": {"value": diff["uniq"], "limit": 0},
        "failed_calls": {"value": run.failed // q, "limit": 0},
        "unchecked": {"value": int(not kept), "limit": 0},
    }
    run.answers_checked = len(kept)


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX
    package, compared whole (``pollen_tpu_torch`` is not ``pollen_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: str, seed: int, seconds: float, traced: bool,
             device="cuda", *, t_start: float | None = None,
             bench: dict | None = None, config: dict | None = None,
             traffic: dict | None = None, fault=None):
    """Run ``cell`` and return (``Run``, result object). ``config`` and
    ``traffic`` stand in for the cell's files, and ``fault`` puts another
    entry in the program's place (``fault(entry, arena) -> entry``),
    for the control and the harness's own tests;
    ``t_start`` is the process's start on the ``time.perf_counter``
    clock (set-up counts from it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or registry.benchmark()
    w = registry.workload(cell, bench)
    run = Run(cell=cell, config=config or registry.config(w["config"]),
              traffic=traffic or registry.traffic(w["traffic"]), seed=seed,
              seconds=seconds, traced=traced, device=torch.device(device))
    g, dg, stream = setup(run)
    entry, route_fn = ENTRIES[run.entry]
    if fault is not None:
        entry = fault(entry, g)
    sample = Sample(run.traffic["check_calls"], run.traffic["check_rows"],
                    run.masks_per_call, _rng(seed, 3))
    run.setup_s = time.perf_counter() - t_start
    window(run, entry, dg, stream, sample)
    if traced:
        t0 = time.perf_counter()
        traced_calls(run, entry, route_fn, dg, stream)
        run.stages["trace_s"] = time.perf_counter() - t0
    dev_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
        dev_info = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(run.device),
                    "count": 1, "memory_peak_bytes": run.memory_peak_bytes,
                    "power_limit": power_limit()}
    del dg
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check(run, g, stream, sample)
    run.stages["check_s"] = time.perf_counter() - t0
    return run, result(run, bench, dev_info)


def result(run: Run, bench: dict, dev_info: dict) -> dict:
    kind = "per_layer" if run.traced else "end_to_end"
    metrics = {}
    for m in registry.metrics(run.cell, kind, bench):
        value = registry.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {
        "correct": all(c["value"] <= c["limit"] for c in run.checks.values()),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": dict(dev_info),
    }
    if run.traced and run.trace is not None:
        out["device"]["busy_s"] = run.trace["busy_s"]
        out["device"]["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = run.checks
    return out
