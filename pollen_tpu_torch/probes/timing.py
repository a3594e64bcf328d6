"""What the probes share: per-call device time on the card, by replaying
a captured CUDA graph, and the bench-shaped crossing matrix they read.

The port of the reference bench's ``_time_chain_raw`` (``bench.py``).
There, a ``fori_loop`` chained the calls through a data dependency so
that XLA could neither drop nor overlap them. Here one stream already
orders the launches: back-to-back calls are captured once in
a ``torch.cuda.CUDAGraph`` and the graph is replayed between two CUDA
events. No host work sits between the launches, so the time per call is
the device's, the gaps between a call's own launches included, whatever
the host spends per call.

The function must not synchronise with the host (no ``.item()``,
``int(tensor)`` or ``.cpu()``): capture refuses that. Its outputs are
dropped as it returns, so the capture reuses their memory from call to
call. Build the kernels before capturing (the warm-up call does it for
a kernel wrapper).
"""

from __future__ import annotations

import os
import statistics
import time

# Published H100 SXM peaks (NVIDIA data sheet), the bounds' rates: HBM
# bytes/s; int8 tensor core ops/s (the dense mask products: 0/1 masks and
# counts <= 127 are exact in int8); float32 ops/s outside the tensor
# cores, taken as the CUDA cores' rate for the integer work of slot
# decoding and scans.
HBM_BPS = 3.35e12
INT8_TENSOR_OPS = 1979e12
CUDA_CORE_OPS = 67e12

REPS = 5  # timed replays (or host calls); the median is kept
TARGET_US = 4000.0  # a replay's length that sizes the graph
MIN_CALLS, MAX_CALLS = 8, 200  # calls captured in one graph


def replay_us(fn) -> float:
    """Median device µs per call of ``fn`` over ``REPS`` replays of a
    graph of back-to-back calls: enough calls for a replay of about
    ``TARGET_US``, ``MIN_CALLS`` to ``MAX_CALLS``."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("replay_us times the card: no CUDA device")
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once_us = max(start.elapsed_time(end) * 1e3, 1e-3)
    calls = int(min(max(TARGET_US / once_us, MIN_CALLS), MAX_CALLS))
    # Warm up on a side stream, as capture wants, then capture there.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) * 1e3 / calls)
    del graph
    return statistics.median(per_call)


def host_us(fn) -> float:
    """Median host-clock µs per call of ``fn`` over ``REPS`` calls (no
    device time: for runs with ``--device cpu``)."""
    fn()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def events_us(fn, device) -> tuple:
    """(median µs per call, what measured it) for a function that reads
    values back to the host, which graph capture refuses: CUDA events
    around each of ``REPS`` calls on the card, the host clock on the
    CPU."""
    import torch

    if device.type != "cuda":
        return host_us(fn), "host clock, cpu"
    fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times), "events"


def time_call(fn, device) -> tuple:
    """(µs per call, what measured it): the graph replay on the card,
    the host clock on the CPU."""
    if device.type == "cuda":
        return replay_us(fn), "device"
    return host_us(fn), "host clock, cpu"


def bench_matrix(device):
    """(nibble matrix, 0/1 mask over the graph's paths, steps) of the
    synthetic graph sized by POLLEN_BENCH_STEPS / SEGS / PATHS (defaults
    2^22 / 2^18 / 128, the reference bench's), ingested on ``device``
    with its crossing matrix resident."""
    import torch

    from ..device import build_graph
    from ..synth import synth_graph

    n_steps = int(os.environ.get("POLLEN_BENCH_STEPS", 2**22))
    n_segs = int(os.environ.get("POLLEN_BENCH_SEGS", 2**18))
    n_paths = int(os.environ.get("POLLEN_BENCH_PATHS", 128))
    t0 = time.perf_counter()
    dg = build_graph(
        synth_graph(n_steps, n_segs, n_paths), device, cross_matrix="always"
    )
    if not dg.cross_nibble:
        raise ValueError("the probes read a nibble-packed crossing matrix")
    print(f"# ingest {time.perf_counter() - t0:.1f}s", flush=True)
    cross = dg.cross_matrix
    mask = torch.zeros(2 * cross.shape[0], dtype=torch.int32, device=cross.device)
    mask[: dg.num_paths] = 1
    return cross, mask, n_steps


def result_line(name: str, us: float, how: str, n_steps: int, tail: str) -> str:
    """The reference probes' result line: ``name: <µs> us/query (<G>
    steps/s) ...``; host-clock times say so."""
    clock = "" if how == "device" else f" [{how}]"
    return (f"{name}: {us:.2f} us/query ({n_steps / us / 1e3:.2f} G steps/s)"
            f"{clock} {tail}").rstrip()
