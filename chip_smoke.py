#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with one CUDA card,
``nvcc`` and PyTorch (no JAX needed). It builds the port's CUDA kernels
from ``pollen_tpu_torch/csrc`` and then:

1. holds every kernel (fused split ELL K1, crossing matrix K2 in both
   layouts and depth-only, tall tier K3 with pack16 and 32-bit slots)
   against its plain PyTorch version on the card, on all fixture graphs
   with 4 seeded masks: exact equality;
2. drives the main path through the user's entry points: ``fgfa-torch
   --device cuda depth -d`` and ``depth -d -s`` on every fixture, byte
   for byte against the goldens, and a ``serve`` loop of three requests;
3. ingests synthetic graphs at bench and chromosome scale, sends 8
   masks each through the routed ``depth -d -s`` query, and checks the
   result against the plain PyTorch path on the card and an independent
   numpy reference; then times one query, kernel against plain.

Launch counts are reset right before phase 2 and read right after
phase 3's queries: every kernel must have been launched by the main
path. Exits nonzero at the first failed check. The second-to-last line
is one JSON object with each kernel's launches, error and time; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
SRC = "pollen_tpu_torch/csrc/depth.cu"
# name -> (TPU kernel replaced, launch-count key)
KERNELS = {
    "ell_splitn (K1)": ("pollen_tpu/kernels/ellscan.py:539", "ell_splitn"),
    "cross (K2)": ("pollen_tpu/kernels/crossmat.py:102", "cross"),
    "ell_tier (K3)": ("pollen_tpu/kernels/ellscan.py:474", "ell_tier"),
}
# Synthetic graphs of phase 3: (steps, segments, paths), seed 8.
SCALE = {
    "bench": (2**22, 2**18, 128),
    "bench_p300": (2**22, 2**18, 300),
    "chr8_third": (2**25, 2**22, 96),
    # An "ell" graph whose heavy block is below SEG_BLOCK: the unfused
    # route, where the main path runs K3 and K2 instead of K1.
    "unfused": (2**20, 2**17, 128),
}
L2_BYTES = 50 * 2**20


class SmokeError(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps=60, warm=5):
    """Median device time of one call, CUDA events around each call."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(fn, reps=30):
    """Device time per call by kernel name (torch.profiler, CUPTI), as
    {name: us}; empty when the trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for evt in prof.events():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            name = evt.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].replace("void ", "")
            per[name] = per.get(name, 0.0) + evt.time_range.elapsed_us() / reps
    return per


def describe_profile(per: dict) -> str:
    if not per:
        return "device time not measured (no device events in the trace)"
    busy = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    return f"device busy {busy:.2f} us/call: " + ", ".join(
        f"{n} {us:.2f}" for n, us in top
    )


def reset_launches():
    from pollen_tpu_torch.kernels import crossmat, ellscan

    for counts in (ellscan.launches, crossmat.launches):
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict:
    from pollen_tpu_torch.kernels import crossmat, ellscan

    return {**ellscan.launches, **crossmat.launches}


class Errors:
    """Largest |kernel - plain| seen per kernel."""

    def __init__(self):
        self.max = {name: None for name in KERNELS}

    def compare(self, name, got, want, what):
        import torch

        for g, w in zip(got, want):
            need(g.shape == w.shape and g.dtype == w.dtype,
                 f"{name} {what}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            prev = self.max[name]
            self.max[name] = err if prev is None else max(prev, err)
            need(torch.equal(g, w), f"{name} {what}: max |err| {err}")


def phase_kernels(errs: Errors):
    """Phase 1: each kernel against its plain version on the fixtures."""
    import numpy as np
    import torch

    from pollen_tpu_torch import parse_gfa_file
    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.kernels import crossmat as cm
    from pollen_tpu_torch.kernels import ellscan as ell

    rng = np.random.default_rng(0)
    graphs = sorted((REPO / "tests" / "graphs").glob("*.gfa"))
    need(len(graphs) == 8, f"expected 8 fixture graphs, found {len(graphs)}")
    for path in graphs:
        g = parse_gfa_file(str(path))
        os.environ["POLLEN_ELL_PACK16"] = "0"
        try:
            dg32 = build_graph(g, "cuda", cross_matrix="always")
        finally:
            del os.environ["POLLEN_ELL_PACK16"]
        dg16 = build_graph(g, "cuda", cross_matrix="always")
        need(dg16.ell_pack16 == 1 and dg32.ell_pack16 == 0, "pack16 layouts")
        # An int8 matrix from the same run index (clip 127).
        r = int(dg16.run_seg_bounds[-1])
        run_seg = np.repeat(
            np.arange(g.num_segments), np.diff(dg16.run_seg_bounds.cpu().numpy())
        )
        p_pad = -(-g.num_paths // 128) * 128
        n_pad = -(-g.num_segments // 128) * 128
        a8 = np.zeros((p_pad, n_pad), np.int8)
        a8[dg16.run_path[:r].cpu().numpy(), run_seg] = np.minimum(
            dg16.run_count[:r].cpu().numpy(), cm.CLIP
        )
        a8 = torch.from_numpy(a8).cuda()
        for _ in range(4):
            m = torch.from_numpy(rng.random(g.num_paths) < 0.5).cuda()
            mp = torch.zeros(p_pad, dtype=torch.int32, device="cuda")
            mp[: g.num_paths] = m.to(torch.int32)
            what = f"{path.name}"
            cross = dg16.cross_matrix
            nib = dg16.cross_nibble
            errs.compare(
                "cross (K2)",
                cm.masked_cross_depth(cross, m, nibble=nib),
                cm.masked_cross_depth_plain(cross, mp[: cross.shape[0] * (2 if nib else 1)], nibble=nib),
                what + " cross matrix",
            )
            errs.compare(
                "cross (K2)",
                [cm.masked_cross_depth(a8, m, nibble=False, uniq=False)],
                cm.masked_cross_depth_plain(a8, mp, nibble=False)[:1],
                what + " int8 depth-only",
            )
            errs.compare(
                "cross (K2)",
                cm.masked_cross_depth(a8, m, nibble=False),
                cm.masked_cross_depth_plain(a8, mp, nibble=False),
                what + " int8",
            )
            for dg in (dg16, dg32):
                tiers = [
                    (t, k)
                    for t, k in (
                        (dg.cross_ell, dg.ell_k),
                        (dg.cross_ell2, dg.ell_k2),
                        (dg.cross_ell3, dg.ell_k3),
                    )
                    if t.numel()
                ]
                p16 = bool(dg.ell_pack16)
                for t, k in tiers:
                    errs.compare(
                        "ell_tier (K3)",
                        ell.masked_ell_depth_tall(t, m, k, pack16=p16),
                        ell.masked_ell_depth_tall_plain(t, m, k, pack16=p16),
                        f"{what} tier k={k} pack16={p16}",
                    )
                args = (
                    [t for t, _ in tiers], dg.ell_heavy, m, [k for _, k in tiers]
                )
                errs.compare(
                    "ell_splitn (K1)",
                    ell.masked_ell_splitn_depth(*args, pack16=p16),
                    ell.masked_ell_splitn_depth_plain(*args, pack16=p16),
                    f"{what} fused pack16={p16}",
                )
    torch.cuda.synchronize()
    print("phase 1: kernels equal their plain versions on 8 fixtures, "
          "4 masks each (tolerance 0: exact integer counts)", flush=True)


def run_cli(argv, stdin_text=""):
    from pollen_tpu_torch import cli

    out = io.StringIO()
    cli.main(argv, stdin=io.StringIO(stdin_text), stdout=out)
    return out.getvalue()


def phase_goldens():
    """Phase 2: the user's entry points on the fixtures, on the card."""
    graphs = REPO / "tests" / "graphs"
    golden = REPO / "tests" / "golden"
    for path in sorted(graphs.glob("*.gfa")):
        stem = path.stem
        got = run_cli(["--device", "cuda", "-I", str(path), "depth", "-d"])
        need(got == (golden / f"{stem}.depth").read_text(),
             f"depth -d differs from the golden on {path.name}")
        got = run_cli([
            "--device", "cuda", "-I", str(path), "depth", "-d", "-s",
            str(golden / f"{stem}.depthpaths"),
        ])
        need(got == (golden / f"{stem}.depth_subset").read_text(),
             f"depth -d -s differs from the golden on {path.name}")
    subset = golden / "rand1.depthpaths"
    requests = f"depth -d -s {subset}\ndepth -d\ndepth -d -s {subset}\n"
    text = run_cli(
        ["--device", "cuda", "-I", str(graphs / "rand1.gfa"), "serve"],
        requests,
    )
    frames = [ln for ln in text.splitlines() if ln.startswith("##end")]
    need(frames == ["##end\tok"] * 3, f"serve frames: {frames}")
    want = (golden / "rand1.depth_subset").read_text()
    need(text.startswith(want + "##end\tok\n"), "serve answer differs")
    print("phase 2: goldens byte-identical on cuda for 8 fixtures "
          "(depth -d, depth -d -s); serve answered 3 requests ##end ok",
          flush=True)


def scale_masks(p, rng):
    import numpy as np

    masks = [np.ones(p, bool), np.arange(p) < p // 2, np.arange(p) % 2 == 0]
    masks += [rng.random(p) < f for f in (0.5, 0.5, 0.25, 0.75, 0.1)]
    return masks


def numpy_reference(dg, mask):
    import numpy as np

    rsb = dg.run_seg_bounds.cpu().numpy()
    r = int(rsb[-1])
    run_seg = np.repeat(np.arange(dg.num_segments), np.diff(rsb))
    run_path = dg.run_path[:r].cpu().numpy()
    run_count = dg.run_count[:r].cpu().numpy()
    w = mask[run_path]
    depth = np.bincount(run_seg, w * run_count, minlength=dg.num_segments)
    uniq = np.bincount(run_seg, w, minlength=dg.num_segments)
    return depth.astype(np.int64), uniq.astype(np.int64)


def index_bytes(dg) -> int:
    return sum(
        t.numel() * t.element_size()
        for t in (
            dg.cross_ell, dg.cross_ell2, dg.cross_ell3, dg.ell_heavy,
            dg.ell_heavy_res, dg.ell_heavy_res_col,
        )
    )


def phase_scale(graphs: dict):
    """Phase 3 (main-path part): ingest and 8 routed queries per graph."""
    import numpy as np
    import torch

    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.ops import depth as depth_op
    from pollen_tpu_torch.synth import synth_graph

    rng = np.random.default_rng(8)
    for name, shape in SCALE.items():
        g = synth_graph(*shape)
        t0 = time.perf_counter()
        dg = build_graph(g, "cuda")
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        pick = depth_op._best_masked_impl(dg)
        need(pick == "ell", f"{name}: router picked {pick!r}, expected 'ell'")
        plan = dict(
            ks=[k for k in (dg.ell_k, dg.ell_k2, dg.ell_k3) if k],
            pack16=dg.ell_pack16,
            tier_cols=[dg.ell_num_light, dg.ell_num_mid, dg.ell_num_mid2],
            heavy_cols=dg.ell_num_heavy,
            heavy_block=list(dg.ell_heavy.shape),
            fused=dg.ell_heavy.shape[1] % 8192 == 0,
            index_bytes=index_bytes(dg),
        )
        print(f"{name}: {shape[0]} steps, {shape[1]} segments, {shape[2]} "
              f"paths; ingest {ingest_s:.3f} s; router {pick}; plan {plan}",
              flush=True)
        before = launch_counts()
        names = [b.decode() for b in g.path_names()]
        for i, m in enumerate(scale_masks(g.num_paths, rng)):
            mt = torch.from_numpy(m)
            d, u = depth_op.masked_seg_depth(dg, mt)
            d_ref, u_ref = numpy_reference(dg, m)
            need(np.array_equal(d, d_ref) and np.array_equal(u, u_ref),
                 f"{name} mask {i}: differs from the numpy reference")
            d_pl, u_pl = depth_op.seg_depth_with_uniq_ell(
                dg, mt.cuda(), plain=True
            )
            need(np.array_equal(d, d_pl.numpy())
                 and np.array_equal(u, u_pl.numpy()),
                 f"{name} mask {i}: differs from the plain torch path")
            if i == 1:
                text = depth_op.run_seg_depth(
                    g, dg, [n for n, keep in zip(names, m) if keep]
                )
                need(text == depth_op.seg_depth_table(g, d_ref, u_ref),
                     f"{name}: depth -d -s table differs")
        after = launch_counts()
        moved = {k: after[k] - before[k] for k in after}
        key = "ell_splitn" if plan["fused"] else "ell_tier"
        need(moved[key] >= 8, f"{name}: {key} launches {moved}")
        print(f"{name}: 8 masks equal numpy reference and plain torch; "
              f"launches {moved}", flush=True)
        graphs[name] = (g, dg)


def phase_timing(graphs: dict, card: str) -> dict:
    """Phase 3 (timing): one query and each kernel, kernel vs plain."""
    import numpy as np
    import torch

    from pollen_tpu_torch.kernels import crossmat as cm
    from pollen_tpu_torch.kernels import ellscan as ell
    from pollen_tpu_torch.ops import depth as depth_op

    rng = np.random.default_rng(1)
    for name, (g, dg) in graphs.items():
        m = torch.from_numpy(rng.random(g.num_paths) < 0.5).cuda()
        k_ms = cuda_ms(lambda: depth_op.seg_depth_with_uniq_ell_parts(dg, m))
        p_ms = cuda_ms(
            lambda: depth_op.seg_depth_with_uniq_ell_parts(dg, m, plain=True)
        )
        steps = g.num_steps
        prof_k = device_profile(
            lambda: depth_op.seg_depth_with_uniq_ell_parts(dg, m)
        )
        print(f"{name}: query with kernels, {describe_profile(prof_k)}; "
              f"idle share "
              f"{1 - sum(prof_k.values()) / (k_ms * 1e3):.3f}" if prof_k
              else f"{name}: {describe_profile(prof_k)}", flush=True)
        print(f"{name} [{card}]: query {k_ms * 1e3:.2f} us "
              f"({steps / (k_ms * 1e-3) / 1e9:.2f} G steps/s) with kernels; "
              f"{p_ms * 1e3:.2f} us ({steps / (p_ms * 1e-3) / 1e9:.2f} "
              f"G steps/s) plain; index {index_bytes(dg) / 2**20:.2f} MB "
              f"sits in the {L2_BYTES // 2**20} MB L2", flush=True)

    times = {}
    _, dg = graphs["bench"]
    m = torch.from_numpy(rng.random(dg.num_paths) < 0.5).cuda()
    tiers = [t for t in (dg.cross_ell, dg.cross_ell2, dg.cross_ell3) if t.numel()]
    ks = [k for k in (dg.ell_k, dg.ell_k2, dg.ell_k3) if k]
    args = (tiers, dg.ell_heavy, m, ks)
    p16 = bool(dg.ell_pack16)
    times["ell_splitn (K1)"] = (
        lambda: ell.masked_ell_splitn_depth(*args, pack16=p16),
        lambda: ell.masked_ell_splitn_depth_plain(*args, pack16=p16),
        "bench",
    )
    _, dgu = graphs["unfused"]
    mu = torch.from_numpy(rng.random(dgu.num_paths) < 0.5).cuda()
    mpu = torch.zeros(dgu.ell_heavy.shape[0] * 2, dtype=torch.int32,
                      device="cuda")
    mpu[: dgu.num_paths] = mu.to(torch.int32)
    times["cross (K2)"] = (
        lambda: cm.masked_cross_depth(dgu.ell_heavy, mu, nibble=True),
        lambda: cm.masked_cross_depth_plain(dgu.ell_heavy, mpu, nibble=True),
        "unfused heavy block",
    )
    p16u = bool(dgu.ell_pack16)
    times["ell_tier (K3)"] = (
        lambda: ell.masked_ell_depth_tall(dgu.cross_ell, mu, dgu.ell_k, p16u),
        lambda: ell.masked_ell_depth_tall_plain(
            dgu.cross_ell, mu, dgu.ell_k, p16u
        ),
        "unfused tier 1",
    )
    out = {}
    for name, (kern, plain, where) in times.items():
        got, want = kern(), plain()
        for a, b in zip(got if isinstance(got, tuple) else [got], want):
            need(torch.equal(a, b), f"{name} at {where}: kernel != plain")
        out[name] = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                     cuda_ms(plain), where)
        print(f"{name} at {where}: kernel call, "
              f"{describe_profile(device_profile(kern))}; plain call, "
              f"{describe_profile(device_profile(plain))}", flush=True)
    return out


def main() -> int:
    if not (REPO / "pollen_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(pollen_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    from pollen_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"built {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip().split("ptxas info    : ")[-1])

    errs = Errors()
    phase_kernels(errs)
    reset_launches()
    phase_goldens()
    graphs: dict = {}
    phase_scale(graphs)
    launches = launch_counts()
    print(f"main-path launches: {launches}", flush=True)
    for name, (_, key) in KERNELS.items():
        need(launches[key] > 0, f"{name} was never launched by the main path")

    timing = phase_timing(graphs, card)
    rows = []
    for name, (replaces, key) in KERNELS.items():
        p1, k1, k2, p2, where = timing[name]
        ms, plain_ms = min(k1, k2), min(p1, p2)
        print(f"{name} at {where} [{card}]: kernel {ms * 1e3:.2f} us, "
              f"plain {plain_ms * 1e3:.2f} us (runs plain, kernel, kernel, "
              f"plain: {p1 * 1e3:.2f} {k1 * 1e3:.2f} {k2 * 1e3:.2f} "
              f"{p2 * 1e3:.2f} us)", flush=True)
        rows.append(dict(
            name=name, route="cuda", source=SRC, replaces=replaces,
            launches=launches[key], max_abs_err=errs.max[name],
            ms=ms, plain_ms=plain_ms,
        ))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
