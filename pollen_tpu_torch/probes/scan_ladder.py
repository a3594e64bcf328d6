"""K6's single pass taken apart on the card (``csrc/common.cuh``
``launch_scan_single``): the device time of builds that each change one
parameter of the scan, and one instrumented build that records where a
partition's time goes.

    base      the kernel as it ships (8 items a thread, 2048 elements a
              partition, at most 48 registers: 5 blocks an SM)
    items4    4 items a thread (1024 elements a partition)
    items16   16 items a thread (4096 elements a partition)
    blocks4   at most 64 registers (4 blocks an SM)
    stream    evict-first (streaming) 16-byte output stores
    phases    the kernel as it ships, instrumented: per partition the SM
              clock cycles of taking the ticket, loading and scanning,
              the look-back and the stores, and the look-back's rounds
              (32 predecessors each) and polls (the instrumentation's
              own cost is inside the times it prints)

Each variant is a copy of the package in a temporary directory with
``csrc/common.cuh`` patched (``PATCHES``), built and run by its own
process on 2^25 steps (sorted random path ids over 2^17 paths, a group
every 4 steps, seed 0): checked against the plain version, then timed by
replaying a CUDA graph of back-to-back calls (``timing.replay_us``,
median of 3 replays). Run on the card:

    python -m pollen_tpu_torch.probes.scan_ladder [variant ...]
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile

PKG = pathlib.Path(__file__).resolve().parent.parent
HEADER = "csrc/common.cuh"
N_STEPS = 2**25
N_PATHS = 2**17

_STORE = ("*reinterpret_cast<int4*>(op.out{k} + i0 + j) =\n"
          "          make_int4(o{k}[j], o{k}[j + 1], o{k}[j + 2], o{k}[j + 3]);")
_STREAM = ("__stcs(reinterpret_cast<int4*>(op.out{k} + i0 + j),\n"
           "             make_int4(o{k}[j], o{k}[j + 1], o{k}[j + 2], o{k}[j + 3]));")

# The instrumented build: a third of the scratch per kind of record, a
# partition's phases into the second third (cycles) and its look-back
# counts into the last (rounds, polls).
_PHASES = {
    "return SCAN_HEADER_BYTES + single_scan_parts(n) * (long long)sizeof(int4);":
        "return SCAN_HEADER_BYTES +\n"
        "         3 * single_scan_parts(n) * (long long)sizeof(int4);",
    "// Publishes partition `part`'s aggregate and returns its exclusive":
        "__shared__ int s_probe_rounds, s_probe_polls;\n\n"
        "// Publishes partition `part`'s aggregate and returns its exclusive",
    "  for (int end = part;; end -= 32) {\n":
        "  int rounds = 0, polls = 0;\n"
        "  for (int end = part;; end -= 32) {\n"
        "    ++rounds;\n",
    "      if (!desc_ready(flag)) flag = Op::from_desc(ld_desc(desc + p), v);":
        "      ++polls;\n"
        "      if (!desc_ready(flag)) flag = Op::from_desc(ld_desc(desc + p), v);",
    "    if (pre) return run;  // partition 0 is always FLAG_PREFIX":
        "    if (pre) {\n"
        "      if (lane == 0) {\n"
        "        s_probe_rounds = rounds;\n"
        "        s_probe_polls = polls;\n"
        "      }\n"
        "      return run;\n"
        "    }",
    "  for (;;) {\n"
    "    if (threadIdx.x == 0) s_part = atomicAdd(counter, 1);\n"
    "    __syncthreads();\n"
    "    const int part = s_part;\n"
    "    if (part >= parts) break;  // block-uniform\n":
        "  for (;;) {\n"
        "    const long long t0 = clock64();\n"
        "    if (threadIdx.x == 0) s_part = atomicAdd(counter, 1);\n"
        "    __syncthreads();\n"
        "    const int part = s_part;\n"
        "    if (part >= parts) break;  // block-uniform\n"
        "    const long long t1 = clock64();\n"
        "    if (threadIdx.x == 0) s_probe_rounds = s_probe_polls = 0;\n",
    "        thread_aggregate(op, base, x, y, w), s_tot, &total);\n"
    "    if (threadIdx.x < 32) {":
        "        thread_aggregate(op, base, x, y, w), s_tot, &total);\n"
        "    const long long t2 = clock64();\n"
        "    if (threadIdx.x < 32) {",
    "    __syncthreads();\n"
    "    emit_items(op, base, x, y, w, Op::combine(s_prefix, excl));\n"
    "  }":
        "    __syncthreads();\n"
        "    const long long t3 = clock64();\n"
        "    emit_items(op, base, x, y, w, Op::combine(s_prefix, excl));\n"
        "    const long long t4 = clock64();\n"
        "    if (threadIdx.x == 0) {\n"
        "      desc[parts + part] = make_int4((int)(t1 - t0), (int)(t2 - t1),\n"
        "                                     (int)(t3 - t2), (int)(t4 - t3));\n"
        "      desc[2 * parts + part] =\n"
        "          make_int4(s_probe_rounds, s_probe_polls, 0, 0);\n"
        "    }\n"
        "  }",
}

PATCHES = {
    "base": {},
    "items4": {"constexpr int SCAN_ITEMS = 8;": "constexpr int SCAN_ITEMS = 4;"},
    "items16": {"constexpr int SCAN_ITEMS = 8;": "constexpr int SCAN_ITEMS = 16;"},
    "blocks4": {"constexpr int SINGLE_MIN_BLOCKS = 5;":
                "constexpr int SINGLE_MIN_BLOCKS = 4;"},
    "stream": {_STORE.format(k=k): _STREAM.format(k=k) for k in (0, 1)},
    "phases": _PHASES,
}


def patched(text: str, patch: dict) -> str:
    """``text`` with each key of ``patch`` (found exactly once) replaced."""
    for old, new in patch.items():
        if text.count(old) != 1:
            raise ValueError(f"patch target not found once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def scan_inputs():
    """(path ids, group starts, mask) on the card, seed 0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    path = np.sort(rng.integers(0, N_PATHS, N_STEPS)).astype(np.int32)
    run_start = np.arange(N_STEPS, dtype=np.int32) // 4 * 4
    mask = rng.random(N_PATHS) < 0.5
    return tuple(torch.from_numpy(a).cuda() for a in (path, run_start, mask))


def measure(variant: str) -> bool:
    """In a patched copy: check, time, and for ``phases`` summarise;
    returns whether the scan equalled its plain version."""
    import numpy as np
    import torch

    from ..kernels import _build, segscan
    from .timing import replay_us

    _build.load()
    path, run_start, mask = scan_inputs()
    scratch = {}
    sized = segscan.scan_scratch

    def keep(*args):
        scratch["t"] = sized(*args)
        return scratch["t"]

    segscan.scan_scratch = keep
    got = segscan.masked_depth_cumsums(path, run_start, mask)
    want = segscan.masked_depth_cumsums_plain(path, run_start, mask)
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    fn = lambda: segscan.masked_depth_cumsums(path, run_start, mask)  # noqa: E731
    us = statistics.median(replay_us(fn) for _ in range(3))
    print(f"{variant}: {us:.2f} us device ({N_STEPS} steps), exact={exact}",
          flush=True)
    if variant != "phases":
        return exact
    fn()
    torch.cuda.synchronize()
    parts = -(-N_STEPS // (256 * 8))
    rec = scratch["t"].cpu().numpy()[4:].reshape(-1, 4).astype(np.int64)
    cycles, counts = rec[parts:2 * parts][1:], rec[2 * parts:][1:]
    for i, name in enumerate(("ticket", "load+scan", "look-back", "stores")):
        c = cycles[:, i]
        print(f"  {name}: median {np.median(c):.0f}, mean {c.mean():.0f}, "
              f"p90 {np.percentile(c, 90):.0f} cycles", flush=True)
    rounds, polls = counts[:, 0], counts[:, 1]
    print(f"  look-back rounds: mean {rounds.mean():.2f}, max {rounds.max()}; "
          f"polls: mean {polls.mean():.2f}, p90 {np.percentile(polls, 90):.0f}",
          flush=True)
    return exact


def run(which) -> int:
    """Each variant in its own patched copy and process; returns the
    number that failed."""
    failed = 0
    source = (PKG / HEADER).read_text()
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=False, timeout=60)
    for variant in which:
        with tempfile.TemporaryDirectory() as tmp:
            copy = pathlib.Path(tmp) / PKG.name
            shutil.copytree(PKG, copy, ignore=shutil.ignore_patterns(
                "_build", "__pycache__"))
            (copy / HEADER).write_text(patched(source, PATCHES[variant]))
            proc = subprocess.run(
                [sys.executable, "-m", f"{PKG.name}.probes.scan_ladder",
                 "--one", variant],
                cwd=tmp, timeout=900,
            )
            failed += proc.returncode != 0
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"any of {', '.join(PATCHES)}")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return 0 if measure(args.one) else 1
    which = args.variants or list(PATCHES)
    bad = [v for v in which if v not in PATCHES]
    if bad:
        ap.error(f"unknown variants {bad}; choose from {', '.join(PATCHES)}")
    return 1 if run(which) else 0


if __name__ == "__main__":
    sys.exit(main())
