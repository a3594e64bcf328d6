"""K1-K5, K8, K9 and the probe ladder K10-K12 side by side across builds,
on the card, at the shapes of ``chip_smoke.py``'s rows:

    K1  the fused split ELL query (tiers and heavy block in one call) at
        bench (one pack16 tier of k = 2, a 64 x 16,384 heavy block) and
        chr8_third (three pack16 tiers, 64 x 49,152), under a seeded mask;
    K2  the unfused graph's heavy block (64 x 5376, in L2) under a seeded
        mask, and chr8_third's crossing matrix (64 x 4,194,304, 256 MiB)
        under the mask of every path it has;
    K3  the unfused graph's tier (one tall tier, g = 2), pack16 and, from
        a second ingest with POLLEN_ELL_PACK16=0, 32-bit slots, under a
        seeded mask; and each of chr8_third's three pack16 tiers alone;
    K4  the batched split ELL query on bench's and chr8_third's index,
        Q = 32 seeded masks;
    K5  the batched crossing-matrix query on bench's matrix (64 x
        262,144), the same Q = 32 masks;
    K8  bench_runs' run index (524,288 runs) and wide_p2e17's
        (12,795,904), under seeded masks;
    K9  chr8_third's flat slots from ``build_ell`` (k = 1, 4,194,304
        columns), and its three tiers unfolded to flat 32-bit slots and
        cut to rank 1 of 2's columns, as the sharded ELL query holds
        them: each tier alone, the three a call each, and (where the
        build has ``masked_ell_depth_tiers``) the three in one call;
    K10-K12  the ladder's four rungs (raw, vd, v1, v2 with tile_flags) on
        K2's two matrices under K2's masks, beside K2's row, and v1 under
        a mask that selects no row (what a call costs with no row read).

Each build is a copy of a ``pollen_tpu_torch`` package built and timed by
its own process, in the order given: ``shipped`` (this package as it
is), a patched copy (``VARIANTS``), ``pkg=DIR`` (the package under
another checkout's root DIR, for example an earlier commit unpacked with
``git archive``), or ``VARIANT@DIR`` (that package, patched). Each call
is held against its plain version first, then timed by replaying a CUDA
graph of back-to-back calls (``timing.replay_us``, median of 3), beside
its yardstick: one float32 ``torch.matmul`` of the folded mask by
``[A | min(A, 1)]`` for K2, two 1-D ``torch.cumsum`` calls of the run
index's length for K8.

The ``split_*`` variants take K1 and K4 apart: their wrappers are
patched to pass the tiers alone (``split_tiers``), the heavy block alone
(``split_heavy``: every tier cut to no columns) or neither
(``split_pack``: what a call launches besides its tiers and heavy
block, such as a mask-packing launch), so the same launch code times
each part of the call; ``split_nobits`` and ``split_nostore`` patch
K4's kernel (no mask bits in its heavy blocks; no stores from its tier
blocks) to time what is left. Only the K1 and K4 rows run, unchecked.
K5 also runs on the heavy block K4's tiles read. ``k3_splitn`` runs K3
as a tier-only launch of K1's kernel (its ~40 KB of shared memory for
the heavy tiles' list and sums) instead of its own lean kernel (8 KB of
mask bits). Run on the card:

    python -m pollen_tpu_torch.probes.kernel_ab pkg=OLD shipped shipped \\
        pkg=OLD k3_splitn split_tiers split_heavy split_pack split_heavy@OLD

The graphs are made once (seeded, ``synth.py``) and kept in
``_build/kernel_ab_shapes.pt`` beside the kernel library.
"""

from __future__ import annotations

import argparse
import functools
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile

PKG = pathlib.Path(__file__).resolve().parent.parent
_K1 = "def masked_ell_splitn_depth(\n"
_K4 = "def masked_ell_splitn_depth_batch(\n"


def _split(tiers: str, heavy: str) -> dict:
    """Patches of ``kernels/ellscan.py`` that put a shim in front of the
    K1 and K4 wrappers: it hands the whole wrapper ``tiers`` and
    ``heavy`` (expressions of the call's own arguments)."""
    patch = {}
    for target, mask in ((_K1, "mask"), (_K4, "masks")):
        whole = "_whole_" + target[4:-2]
        patch[target] = (
            f"{target[:-2]}(tiers, heavy, {mask}, ks, pack16=False):\n"
            f"    return {whole}({tiers}, {heavy}, {mask}, ks, pack16)\n\n\n"
            f"def {whole}(\n"
        )
    return {"kernels/ellscan.py": patch}


# Patched copies: {file under the package: {text found once: new text}}.
VARIANTS = {
    "shipped": {},
    # K2's tile without row groups (K2, K1's heavy tiles and the probe
    # ladder): at small matrices each thread walks every selected row of
    # its 16 columns (fewer, longer threads).
    "k2groups1": {"csrc/cross.cuh": {
        "  while (groups < H_GROUPS &&": "  while (groups < 1 &&",
    }},
    # K3 as a tier-only launch of K1's kernel.
    "k3_splitn": {"csrc/depth.cu": {
        "launch_splitn<true, false>(x, st);":
        "launch_splitn<true, true>(x, st);",
    }},
    "split_tiers": _split("tiers", "heavy[:, :0]"),
    "split_heavy": _split("[t[:0] for t in tiers]", "heavy"),
    "split_pack": _split("[t[:0] for t in tiers]", "heavy[:, :0]"),
    # K4's heavy blocks without building their mask bits (the products
    # then read whatever shared memory holds): the tile alone.
    "split_nobits": {"csrc/depth_batch.cu": {
        "      if (!built) return;\n": "      return;\n",
    }},
    # K4's tier blocks with their stores left out (a tier's first chunk
    # of words stores nothing): the loads, mask bits and products alone.
    "split_nostore": {"csrc/depth_batch.cu": {
        "    *pd = make_int4(d[0], d[1], d[2], d[3]);\n"
        "    *pu = make_int4(u[0], u[1], u[2], u[3]);\n":
        "    if (add) {\n"
        "      *pd = make_int4(d[0], d[1], d[2], d[3]);\n"
        "      *pu = make_int4(u[0], u[1], u[2], u[3]);\n"
        "    }\n",
    }},
}
SPLITS = {name for name in VARIANTS if name.startswith("split_")}


def shapes_path() -> pathlib.Path:
    from pollen_tpu_torch.kernels import _build

    return _build.build_dir() / "kernel_ab_shapes.pt"


def _ell_index(dg) -> dict:
    tiers = [(t, k) for t, k in ((dg.cross_ell, dg.ell_k),
                                 (dg.cross_ell2, dg.ell_k2),
                                 (dg.cross_ell3, dg.ell_k3)) if t.numel()]
    return {"tiers": [t for t, _ in tiers], "ks": [k for _, k in tiers],
            "heavy": dg.ell_heavy, "pack16": bool(dg.ell_pack16),
            "num_paths": dg.num_paths}


def make_shapes(path: pathlib.Path) -> None:
    """The inputs, from seeded synthetic graphs ingested on the host,
    saved to ``path``."""
    import numpy as np
    import torch

    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.kernels.ellscan import build_ell
    from pollen_tpu_torch.synth import synth_graph

    unfused = build_graph(synth_graph(2**20, 2**17, 128), "cpu")
    os.environ["POLLEN_ELL_PACK16"] = "0"
    try:
        unfused32 = build_graph(synth_graph(2**20, 2**17, 128), "cpu")
    finally:
        del os.environ["POLLEN_ELL_PACK16"]
    bench = build_graph(synth_graph(2**22, 2**18, 128), "cpu",
                        cross_matrix="always")
    chr8 = build_graph(synth_graph(2**25, 2**22, 96), "cpu",
                       cross_matrix="always")
    data = {
        "unfused": (unfused.ell_heavy, unfused.num_paths),
        "tier pack16": (unfused.cross_ell, unfused.ell_k, unfused.num_paths),
        "tier 32-bit": (unfused32.cross_ell, unfused32.ell_k,
                        unfused32.num_paths),
        "chr8_third": (chr8.cross_matrix, chr8.num_paths),
        "bench_cross": (bench.cross_matrix, bench.num_paths),
        "ell bench": _ell_index(bench),
        "ell chr8_third": _ell_index(chr8),
    }
    rsb = chr8.run_seg_bounds.numpy()
    r = int(rsb[-1])
    run_seg = np.repeat(np.arange(chr8.num_segments), np.diff(rsb))
    flat, _ = build_ell(chr8.run_path[:r].numpy(), chr8.run_count[:r].numpy(),
                        run_seg.astype(np.int32), chr8.num_segments)
    data["flat chr8_third"] = (torch.from_numpy(flat), chr8.num_paths)
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
    from pollen_tpu_torch.kernels import crossprobe as cp
    from pollen_tpu_torch.kernels import ellscan as ell
    from pollen_tpu_torch.kernels import runscan
    from pollen_tpu_torch.probes.timing import replay_us

    split = label.split("@")[0] in SPLITS

    def med(fn):
        return statistics.median(replay_us(fn) for _ in range(3))

    def exact(got, want, what):
        if split:
            return
        if not all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(got, want)):
            raise SystemExit(f"{label}: {what} differs from its plain version")

    _build.load()
    data = torch.load(path)
    gen = torch.Generator().manual_seed(1)
    out = []
    for name in ("bench", "chr8_third"):
        e = data[f"ell {name}"]
        tiers = [t.cuda() for t in e["tiers"]]
        heavy, p16, n_paths = e["heavy"].cuda(), e["pack16"], e["num_paths"]
        m = (torch.rand(n_paths, generator=gen) < 0.5).cuda()
        ms = (torch.rand(32, n_paths, generator=gen)
              < torch.rand(32, 1, generator=gen)).cuda()
        for kname, fn, plain in (
            ("K1", ell.masked_ell_splitn_depth, ell.masked_ell_splitn_depth_plain),
            ("K4 Q=32", ell.masked_ell_splitn_depth_batch,
             ell.masked_ell_splitn_depth_batch_plain),
        ):
            mm = m if kname == "K1" else ms
            call = functools.partial(fn, tiers, heavy, mm, e["ks"], pack16=p16)
            exact(call(), plain(tiers, heavy, mm, e["ks"], pack16=p16),
                  f"{kname} {name}")
            out.append(f"{kname} {name} {med(call):.2f}")
        if not split:  # K5's kernel on the heavy block K4's tiles read
            fn = functools.partial(cm.batched_cross_depth, heavy, ms,
                                   nibble=True)
            exact(fn(), cm.batched_cross_depth_plain(
                heavy, cm.pad_mask(ms, 2 * heavy.shape[0]), nibble=True),
                f"K5 {name} heavy block")
            out.append(f"K5 {name} heavy block Q=32 {med(fn):.2f}")
        del tiers, heavy
    if split:
        print(f"{label}: " + "; ".join(out) + " us device", flush=True)
        return
    a, n_paths = data["bench_cross"]
    a = a.cuda()
    ms = (torch.rand(32, n_paths, generator=gen)
          < torch.rand(32, 1, generator=gen)).cuda()
    fn = functools.partial(cm.batched_cross_depth, a, ms, nibble=True)
    exact(fn(), cm.batched_cross_depth_plain(a, cm.pad_mask(ms, 2 * a.shape[0]),
                                             nibble=True), "K5 bench_cross")
    out.append(f"K5 bench_cross Q=32 {med(fn):.2f}")
    for name in ("pack16", "32-bit"):
        tall, k, n_paths = data[f"tier {name}"]
        tall, p16 = tall.cuda(), name == "pack16"
        m = (torch.rand(n_paths, generator=gen) < 0.5).cuda()
        fn = functools.partial(ell.masked_ell_depth_tall, tall, m, k, p16)
        exact(fn(), ell.masked_ell_depth_tall_plain(tall, m, k, p16),
              f"K3 unfused {name}")
        out.append(f"K3 unfused {name} k={k} {med(fn):.2f}")
    e = data["ell chr8_third"]  # K3 on each of chr8_third's three tiers
    m = (torch.rand(e["num_paths"], generator=gen) < 0.5).cuda()
    for tall, k in zip(e["tiers"], e["ks"]):
        tall = tall.cuda()
        fn = functools.partial(ell.masked_ell_depth_tall, tall, m, k,
                               e["pack16"])
        exact(fn(), ell.masked_ell_depth_tall_plain(tall, m, k, e["pack16"]),
              f"K3 chr8_third k={k}")
        out.append(f"K3 chr8_third tier {tuple(tall.shape)} k={k} "
                   f"{med(fn):.2f}")
    flat, n_paths = data["flat chr8_third"]
    flat = flat.cuda()
    m = (torch.rand(n_paths, generator=gen) < 0.5).cuda()
    fn = functools.partial(ell.masked_ell_depth, flat, m)
    exact(fn(), ell.masked_ell_depth_plain(flat, m), "K9 chr8_third flat")
    out.append(f"K9 chr8_third flat {tuple(flat.shape)} {med(fn):.2f}")
    del flat
    slices = []
    for tall, k in zip(e["tiers"], e["ks"]):
        f = ell.unfold_ell_tall(tall.cuda(), k)
        f = ell.unpair_ell16(f) if e["pack16"] else f
        width = -(-f.shape[1] // (2 * 128)) * 128  # sharded._pad_cols, rank 1
        piece = torch.zeros((f.shape[0], width), dtype=f.dtype, device="cuda")
        piece[:, : f.shape[1] - width] = f[:, width:]
        slices.append(piece)
        fn = functools.partial(ell.masked_ell_depth, piece, m)
        exact(fn(), ell.masked_ell_depth_plain(piece, m), "K9 tier slice")
        out.append(f"K9 chr8_third tier slice {tuple(piece.shape)} {med(fn):.2f}")

    def each():
        return tuple(x for f in slices for x in ell.masked_ell_depth(f, m))

    want = tuple(x for f in slices for x in ell.masked_ell_depth_plain(f, m))
    exact(each(), want, "K9 tier slices, a call each")
    out.append(f"K9 chr8_third 3 tier slices, a call each {med(each):.2f}")
    if hasattr(ell, "masked_ell_depth_tiers"):
        fn = functools.partial(ell.masked_ell_depth_tiers, slices, m)
        exact(fn(), want, "K9 tier slices, one call")
        out.append(f"K9 chr8_third 3 tier slices, one call {med(fn):.2f}")
    del slices
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
        flags = cp.tile_flags(a, cp.TILE)
        rungs = []
        for mode in cp.MODES:
            extra = (flags,) if mode == "v2" else ()
            fn = functools.partial(getattr(cp, f"cross_probe_{mode}"), a, m,
                                   *extra)
            exact(fn(), cp.cross_probe_plain(a, m, mode, *extra),
                  f"{mode} {name}")
            rungs.append(f"{mode} {med(fn):.2f}")
        # v1 under a mask that selects no row: the launch, the list
        # staging and the stores, with no row read.
        none = torch.zeros_like(m)
        fn = functools.partial(cp.cross_probe_v1, a, none)
        exact(fn(), cp.cross_probe_plain(a, none, "v1"), f"v1 {name}, no rows")
        rungs.append(f"v1-no-rows {med(fn):.2f}")
        out.append(f"ladder {name} ({int(flags.sum())}/{flags.numel()} tiles "
                   f"flagged) {' '.join(rungs)}")
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
        variant, _, root = build.partition("@")
        src = pathlib.Path(root).resolve() / PKG.name if root else PKG
        with tempfile.TemporaryDirectory() as tmp:
            copy = pathlib.Path(tmp) / PKG.name
            shutil.copytree(src, copy, ignore=shutil.ignore_patterns(
                "_build", "__pycache__"))
            for rel, patch in VARIANTS[variant].items():
                (copy / rel).write_text(patched((src / rel).read_text(), patch))
            failed += run_one(build, pathlib.Path(tmp), path) != 0
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs="*",
                    help=f"any of {', '.join(VARIANTS)}, pkg=DIR or "
                         "VARIANT@DIR")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    ap.add_argument("--shapes", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        sys.path.insert(0, args.root)
        measure(args.one, pathlib.Path(args.shapes))
        return 0
    builds = args.builds or ["shipped"]
    bad = [b for b in builds
           if b.partition("@")[0] not in VARIANTS and not b.startswith("pkg=")]
    if bad:
        ap.error(f"unknown builds {bad}; choose from {', '.join(VARIANTS)}, "
                 "pkg=DIR or VARIANT@DIR")
    return 1 if run(builds, shapes_path()) else 0


if __name__ == "__main__":
    sys.exit(main())
