"""How far the card's events in a trace sit from the calls that launch
them, and whether ``profiling.device_trace`` keeps every one.

Each run is a fresh process (its first profiler session) that builds a
synthetic graph on the card, makes one routed query to warm it and
traces a second under ``profiling.device_trace`` with the window margin
given (``--margin-ms``; 0 traces the block from its first instruction),
while ``--burn`` host processes spin. The profiler keeps only the
events whose timestamps fall inside its window, so a device clock that
reads behind the host's by more than the margin drops the block's
first events. Each trace prints a line: its kernel launches, the
kernels kept, and the least and largest offset of a kept event on the
card from the runtime call that launched it (µs; negative: the device
clock reads behind the host's). Run on the card:

    python -m pollen_tpu_torch.probes.trace_skew --runs 8 --burn 12 --margin-ms 0 50
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[2]

# argv: the checkout, steps, segments, paths, margin (s), trace
# directory, device.
CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
from pollen_tpu_torch import profiling
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.ops.depth import masked_seg_depth
from pollen_tpu_torch.synth import synth_graph
g = synth_graph(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
dg = build_graph(g, sys.argv[7])
mask = torch.arange(g.num_paths) % 2 == 0
masked_seg_depth(dg, mask)
profiling._TRACE_MARGIN_S = float(sys.argv[5])
with profiling.device_trace(sys.argv[6]):
    masked_seg_depth(dg, mask)
"""

BURN = "import time\nt = time.time()\nwhile time.time() - t < 600:\n    pass\n"


def offsets(events: list) -> dict:
    """A Chrome trace's kernel launches, the kernels kept, and the least
    and largest start of a kept event on the card less the start of the
    runtime call that launched it (µs; None with no such pair)."""
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") == "cuda_runtime"
             and "correlation" in e.get("args", {})}
    launches = sum("LaunchKernel" in e.get("name", "") for e in calls.values())
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    off = [float(e["ts"]) - float(calls[c]["ts"]) for e in device
           if (c := e.get("args", {}).get("correlation")) in calls]
    return {"launches": launches,
            "kernels": sum(e["cat"] == "kernel" for e in device),
            "min_us": min(off) if off else None,
            "max_us": max(off) if off else None}


def run(runs: int, burn: int, margins_ms: list, shape: tuple,
        device: str = "cuda") -> list:
    """``runs`` traces at each margin, alternating margins, each while
    ``burn`` host processes spin; one row each."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(runs):
            for margin in margins_ms:
                burners = [subprocess.Popen([sys.executable, "-c", BURN])
                           for _ in range(burn)]
                try:
                    out = pathlib.Path(tmp) / f"{i}_{margin}"
                    subprocess.run(
                        [sys.executable, "-c", CHILD, str(ROOT),
                         *map(str, shape), str(margin / 1e3), str(out), device],
                        stdin=subprocess.DEVNULL, check=True, timeout=300)
                finally:
                    for b in burners:
                        b.kill()
                        b.wait()
                (trace,) = out.iterdir()
                row = {"run": i, "margin_ms": margin,
                       **offsets(json.loads(trace.read_text())["traceEvents"])}
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--burn", type=int, default=12,
                    help="host processes that spin during each run")
    ap.add_argument("--margin-ms", type=float, nargs="+", default=[0.0, 50.0])
    ap.add_argument("--shape", type=int, nargs=3, default=[2**22, 2**18, 128],
                    metavar=("STEPS", "SEGS", "PATHS"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from ..kernels import _build

        _build.load()  # once, before the runs' processes
    rows = run(args.runs, args.burn, args.margin_ms, tuple(args.shape),
               args.device)
    for margin in args.margin_ms:
        mine = [r for r in rows if r["margin_ms"] == margin]
        lows = [r["min_us"] for r in mine if r["min_us"] is not None]
        print(json.dumps({
            "margin_ms": margin, "runs": len(mine),
            "all_kernels_kept": sum(r["kernels"] == r["launches"] for r in mine),
            "least_offset_us": min(lows) if lows else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
