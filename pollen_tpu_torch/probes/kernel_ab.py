"""K2 (``pollen_cross_depth``) and K8 (``pollen_run_scan``) side by side
across builds, on the card, at the shapes of ``chip_smoke.py``'s rows:

    K2  the unfused graph's heavy block (64 x 5376, in L2) under a seeded
        mask, and chr8_third's crossing matrix (64 x 4,194,304, 256 MiB)
        under the mask of every path it has;
    K8  bench_runs' run index (524,288 runs) and wide_p2e17's
        (12,795,904), under seeded masks.

Each build is a copy of a ``pollen_tpu_torch`` package built and timed by
its own process, in the order given: ``shipped`` (this package as it
is), a patched copy (``VARIANTS``), or ``pkg=DIR`` (the package under
another checkout's root DIR, for example an earlier commit unpacked with
``git archive``). Each call is held against its plain version first,
then timed by replaying a CUDA graph of back-to-back calls
(``timing.replay_us``, median of 3), beside its yardstick: one float32
``torch.matmul`` of the folded mask by ``[A | min(A, 1)]`` for K2, two
1-D ``torch.cumsum`` calls of the run index's length for K8. Run on the
card:

    python -m pollen_tpu_torch.probes.kernel_ab shipped k2groups1 pkg=OLD

The graphs are made once (seeded, ``synth.py``) and kept in
``_build/kernel_ab_shapes.pt`` beside the kernel library.
"""

from __future__ import annotations

import argparse
import functools
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile

PKG = pathlib.Path(__file__).resolve().parent.parent
# Patched copies: {file under the package: {text found once: new text}}.
VARIANTS = {
    "shipped": {},
    # K2 without row groups: at small matrices each thread walks every
    # selected row of its 16 columns (fewer, longer threads).
    "k2groups1": {"csrc/depth.cu": {
        "  while (groups < H_GROUPS &&": "  while (groups < 1 &&",
    }},
}


def shapes_path() -> pathlib.Path:
    from pollen_tpu_torch.kernels import _build

    return _build.build_dir() / "kernel_ab_shapes.pt"


def make_shapes(path: pathlib.Path) -> None:
    """The four inputs, from seeded synthetic graphs ingested on the
    host, saved to ``path``."""
    import torch

    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.synth import synth_graph

    unfused = build_graph(synth_graph(2**20, 2**17, 128), "cpu")
    chr8 = build_graph(synth_graph(2**25, 2**22, 96), "cpu",
                       cross_matrix="always")
    data = {
        "unfused": (unfused.ell_heavy, unfused.num_paths),
        "chr8_third": (chr8.cross_matrix, chr8.num_paths),
    }
    for name, shape, kw in (
        ("bench_runs", (2**22, 2**18, 128), {"cross_matrix": "never"}),
        ("wide_p2e17", (2**25, 2**22, 2**17), {}),
    ):
        dg = build_graph(synth_graph(*shape), "cpu", **kw)
        data[name] = (dg.run_path, dg.run_count, dg.num_paths)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(data, path)


def measure(label: str, path: pathlib.Path) -> None:
    """Check and time one build (the package first on sys.path)."""
    import torch

    from pollen_tpu_torch.kernels import _build
    from pollen_tpu_torch.kernels import crossmat as cm
    from pollen_tpu_torch.kernels import runscan
    from pollen_tpu_torch.probes.timing import replay_us

    def med(fn):
        return statistics.median(replay_us(fn) for _ in range(3))

    def exact(got, want, what):
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"{label}: {what} differs from its plain version")

    _build.load()
    data = torch.load(path)
    gen = torch.Generator().manual_seed(1)
    out = []
    for name in ("unfused", "chr8_third"):
        a, n_paths = data[name]
        a = a.cuda()
        p = 2 * a.shape[0]
        if name == "unfused":
            m = (torch.rand(n_paths, generator=gen) < 0.5).cuda()
        else:
            m = torch.ones(n_paths, dtype=torch.int32, device="cuda")
        mp = cm.pad_mask(m, p)
        fn = functools.partial(cm.masked_cross_depth, a, m, nibble=True)
        exact(fn(), cm.masked_cross_depth_plain(a, mp, nibble=True), f"K2 {name}")
        lib = torch.cat([cm.unpack_cross(a), torch.clamp(cm.unpack_cross(a), max=1)],
                        dim=1).float()
        fm = cm.fold_mask(mp).float()[None]
        out.append(f"K2 {name} {med(fn):.2f} (matmul "
                   f"{med(lambda: torch.matmul(fm, lib)):.2f})")
        del lib
        torch.cuda.empty_cache()
    for name in ("bench_runs", "wide_p2e17"):
        rp, rc, n_paths = data[name]
        rp, rc = rp.cuda(), rc.cuda()
        m = (torch.rand(n_paths, generator=gen) < 0.5).cuda()
        fn = functools.partial(runscan.masked_run_cumsums, rp, rc, m)
        exact(fn(), runscan.masked_run_cumsums_plain(rp, rc, m), f"K8 {name}")
        ones = torch.ones(rp.shape[0], dtype=torch.int32, device="cuda")
        cumsum = functools.partial(torch.cumsum, ones, 0, dtype=torch.int32)
        out.append(f"K8 {name} {med(fn):.2f} (two 1-D cumsums "
                   f"{2 * med(cumsum):.2f})")
    print(f"{label}: " + "; ".join(out) + " us device", flush=True)


def run_one(label: str, root: pathlib.Path, path: pathlib.Path) -> int:
    proc = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--one", label,
         "--root", str(root), "--shapes", str(path)],
        cwd=root, timeout=900,
    )
    return proc.returncode


def run(builds, path: pathlib.Path) -> int:
    """Each build in its own process; returns the number that failed."""
    from pollen_tpu_torch.probes.scan_ladder import patched

    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=False, timeout=60)
    if not path.exists():
        make_shapes(path)
    failed = 0
    for build in builds:
        if build.startswith("pkg="):
            failed += run_one(build, pathlib.Path(build[4:]).resolve(), path) != 0
            continue
        with tempfile.TemporaryDirectory() as tmp:
            copy = pathlib.Path(tmp) / PKG.name
            shutil.copytree(PKG, copy, ignore=shutil.ignore_patterns(
                "_build", "__pycache__"))
            for rel, patch in VARIANTS[build].items():
                (copy / rel).write_text(patched((PKG / rel).read_text(), patch))
            failed += run_one(build, pathlib.Path(tmp), path) != 0
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs="*",
                    help=f"any of {', '.join(VARIANTS)}, or pkg=DIR")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    ap.add_argument("--shapes", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        sys.path.insert(0, args.root)
        measure(args.one, pathlib.Path(args.shapes))
        return 0
    builds = args.builds or ["shipped"]
    bad = [b for b in builds if b not in VARIANTS and not b.startswith("pkg=")]
    if bad:
        ap.error(f"unknown builds {bad}; choose from {', '.join(VARIANTS)} "
                 "or pkg=DIR")
    return 1 if run(builds, shapes_path()) else 0


if __name__ == "__main__":
    sys.exit(main())
