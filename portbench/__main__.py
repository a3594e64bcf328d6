"""Run one cell of the benchmark and print its result line.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` ``breakdown``, and last ``checks``: each number compared with the
reference beside its limit, which also close standard error. Without a
card, with fewer cards than the cell asks for, or with JAX or the JAX
package loaded once the window has closed, the run prints no result
and exits non-zero.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse
import json
import os
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), or since this
    module was imported where ``/proc`` cannot say."""
    try:
        fields = pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _T_IMPORT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter() - process_age_s()
    # Kernel caches at fixed paths inside the checkout (the port builds
    # its nvcc library into pollen_tpu_torch/_build/ itself).
    cache = HERE / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    import torch

    from . import registry

    bench = registry.benchmark()
    cell = registry.workload(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from . import harness

    run, out = harness.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), "cuda", t_start=t_start,
                                bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    if run.entry == "single" and run.latencies_s:
        lat = sorted(run.latencies_s)
        print(f"query latency: median {1e3 * lat[len(lat) // 2]} ms, "
              f"{len(lat)} queries", file=sys.stderr)
    print(f"window {run.window_s} s, {run.calls} calls, route {run.route}, "
          f"setup {run.setup_s} s (ingest {run.ingest_s} s), "
          f"{run.answers_checked} answers checked; stages "
          + ", ".join(f"{k} {v}" for k, v in run.stages.items()), file=sys.stderr)
    print("host: " + ", ".join(f"{k} {v}" for k, v in run.host.items()),
          file=sys.stderr)
    print(json.dumps(out))
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
