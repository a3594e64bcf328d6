"""The multi-rank dry run: every sharded query on a real job of n ranks.

A port of ``__graft_entry__.py`` ``dryrun_multichip``. The reference
runs its mesh on n virtual devices of one process; here n ranks are
spawned (launch.py), each runs the same checks on its own piece, and
every sharded answer is gathered and held against the single-device
port query on the same rank, exactly (int32).

    python -m pollen_tpu_torch.parallel.dryrun 8 [--device cpu]

Layouts exercised: step-list tensors sharded by contiguous chunk over
both mesh axes, segment tables replicated, partial histograms summed
over the job, and a cross-chunk all-gather carry for the distinct-path
count. Two phases: a tiny fixture with hand-checked answers, then a
generated Zipf-crossed graph (2^20 steps / 2^16 segments / 128 paths)
big enough that the tiered ELL split has every class non-empty (tier-1
/ tier-2 / heavy / empty), (segment, path) groups straddle chunk
bounds, and the fused per-rank segment scan's look-back carry is live.
Every sharded form (cumsum scan, fused scan on K6, scatter output,
crossing matrix, tiered ELL, batched tiered ELL, degree) is checked.
On the card, ranks take ``cuda:rank % cards``, over NCCL when each has
a card of its own and over gloo otherwise.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import launch
from .collectives import all_gather, all_reduce_sum, gather_shards

TINY_GFA = (
    "H\tVN:Z:1.0\n"
    "S\t1\tACGT\nS\t2\tTT\nS\t3\tGATTACA\nS\t4\tC\n"
    "P\talpha\t1+,2+,3+,2-\t*\nP\tbeta\t1+,2+,4+\t*\n"
    "L\t1\t+\t2\t+\t0M\nL\t2\t+\t3\t+\t0M\nL\t2\t+\t4\t+\t0M\n"
)
GENERATED = (2**20, 2**16, 128)  # steps, segments, paths
Q_BATCH = 4


def foreign_modules() -> list:
    """Modules of JAX or of the reference package this process loaded
    (none may be: the card's machine has no JAX)."""
    return sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "pollen_tpu")
    )


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _equal(got, want, what: str) -> None:
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want.cpu() if isinstance(want, torch.Tensor) else want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = np.flatnonzero(got.reshape(-1) != want.reshape(-1))[:5]
        raise AssertionError(f"{what}: differs (first positions {bad.tolist()})")


def scatter_whole(x: torch.Tensor, mesh) -> torch.Tensor:
    """The scatter query's output whole: this host row's chip slices."""
    return gather_shards(x, mesh.get_group("chip"))


def ell_natural(dg, se, mesh, mask, batch=False):
    """Run the sharded (batched) tiered ELL query, gather every part and
    compose natural order on the host; a list of (d, u) per query."""
    from . import sharded

    has = dict(has_heavy=se.heavy is not None, has_mid=se.ell2 is not None,
               has_mid2=se.ell3 is not None)
    fn = sharded.sharded_ell_depth_batch_fn if batch else sharded.sharded_ell_depth_fn
    parts = [gather_shards(p) for p in fn(mesh, **has)(*sharded.ell_args(se, mask))]
    if not batch:
        parts = [p[None] for p in parts]
    return [
        sharded.compose_ell_parts_natural(dg, [p[q] for p in parts], **has)
        for q in range(parts[0].shape[0])
    ]


def _tiny_phase(mesh, device) -> dict:
    from ..device import build_graph
    from ..flatgfa import parse_gfa
    from . import sharded

    g = parse_gfa(TINY_GFA.encode())
    dg = build_graph(g, device)
    sg = sharded.shard_device_graph(dg, mesh)
    full = sharded.full_mask(dg.num_paths, device)
    n = dg.num_segments

    depth, uniq = sharded.sharded_seg_depth_fn(mesh)(sg, full)
    _equal(depth, [2, 3, 1, 1], "tiny depth")
    _equal(uniq, [2, 2, 1, 1], "tiny uniq")
    d_s, _ = sharded.sharded_seg_depth_scatter_fn(mesh)(sg, full)
    _equal(scatter_whole(d_s, mesh)[:n], depth, "tiny scatter depth")
    deg = sharded.sharded_degree_fn(mesh)(*sharded.shard_degree_inputs(dg, mesh))
    _equal(deg, [1, 3, 1, 1], "tiny degree")

    sc = sharded.shard_cross_inputs(dg, mesh)
    _check(sc is not None, "tiny: no crossing matrix")
    m = torch.zeros(sc.num_paths_padded, dtype=torch.int32, device=device)
    m[: dg.num_paths] = 1
    d_c, u_c = sharded.sharded_cross_depth_fn(mesh, nibble=sc.nibble)(
        sc.cross, sc.res, sc.res_seg, m
    )
    _equal(gather_shards(d_c)[:n], depth, "tiny cross depth")
    _equal(gather_shards(u_c)[:n], uniq, "tiny cross uniq")

    se = sharded.shard_ell_inputs(dg, mesh)
    _check(se is not None, "tiny: no ELL index")
    ones = torch.ones(dg.num_paths, dtype=torch.int32, device=device)
    ((d_e, u_e),) = ell_natural(dg, se, mesh, ones)
    _equal(d_e, depth, "tiny ELL depth")
    _equal(u_e, uniq, "tiny ELL uniq")
    return {"depth": depth.tolist(), "degree": deg.tolist()}


def _generated_phase(mesh, device) -> dict:
    from ..device import build_graph
    from ..kernels import ellscan
    from ..ops import depth as depth_op
    from ..synth import synth_graph
    from . import sharded

    n_steps, n_segs, n_paths = GENERATED
    # Zero the planner's per-phase fixed cost for this build so the
    # CPU-sized graph still splits into tier-1/tier-2/heavy/empty (the
    # production constants fold small tiers away below bench scale).
    fixed = ellscan.C_TIER_FIXED
    ellscan.C_TIER_FIXED = 0.0
    try:
        dg = build_graph(synth_graph(n_steps, n_segs, n_paths), device)
    finally:
        ellscan.C_TIER_FIXED = fixed
    n = dg.num_segments
    ne = n - dg.ell_num_light - dg.ell_num_mid - dg.ell_num_mid2 - dg.ell_num_heavy
    classes = (dg.ell_num_light, dg.ell_num_mid, dg.ell_num_heavy, ne)
    _check(all(c > 0 for c in classes), f"ELL classes must all be non-empty, got {classes}")

    rng = np.random.default_rng(17)
    m_np = np.zeros(n_paths + 1, np.int32)
    m_np[:n_paths] = rng.integers(0, 2, n_paths)
    mask_ext = torch.from_numpy(m_np).to(device)
    mask_p = mask_ext[:-1].bool()
    d_ref, u_ref = depth_op.seg_depth_with_uniq_masked(dg, mask_p)

    # Sequence-parallel scan family on chunks with straddling groups:
    # the cumsum form and the fused per-rank K6 with its device carry.
    sg = sharded.shard_device_graph(dg, mesh, block=sharded.SCAN_BLOCK)
    straddles = int(all_reduce_sum(
        (sg.run_start[:1] < sg.chunk_starts[sg.index]).to(torch.int32)
    ))
    _check(straddles > 0, "no (segment, path) group straddles a chunk")
    for name, fn in (("cumsum scan", sharded.sharded_seg_depth_fn),
                     ("fused scan (K6)", sharded.sharded_seg_depth_fused_fn)):
        d, u = fn(mesh)(sg, mask_ext)
        _equal(d, d_ref, f"{name} depth")
        _equal(u, u_ref, f"{name} uniq")
    d_s, u_s = sharded.sharded_seg_depth_scatter_fn(mesh)(sg, mask_ext)
    _equal(scatter_whole(d_s, mesh)[:n], d_ref, "scatter depth")
    _equal(scatter_whole(u_s, mesh)[:n], u_ref, "scatter uniq")

    # Tensor-parallel crossing matrix (nibble-packed at this shape), and
    # the single-device crossing-matrix query too.
    sc = sharded.shard_cross_inputs(dg, mesh)
    _check(sc is not None, "generated graph: no crossing matrix")
    mc = torch.zeros(sc.num_paths_padded, dtype=torch.int32, device=device)
    mc[:n_paths] = mask_ext[:-1]
    d_c, u_c = sharded.sharded_cross_depth_fn(mesh, nibble=sc.nibble)(
        sc.cross, sc.res, sc.res_seg, mc
    )
    _equal(gather_shards(d_c)[:n], d_ref, "cross depth")
    _equal(gather_shards(u_c)[:n], u_ref, "cross uniq")
    d_c1, u_c1 = depth_op.seg_depth_with_uniq_cross(dg, mask_p)
    _equal(d_c1, d_ref, "single-device cross depth")
    _equal(u_c1, u_ref, "single-device cross uniq")

    # Tensor-parallel tiered split ELL: tier 1, tier 2 and heavy present
    # and column-sharded, zero collectives; then the batch at Q = 4,
    # each answer against its own single-device masked query.
    se = sharded.shard_ell_inputs(dg, mesh)
    _check(se is not None and se.ell2 is not None and se.heavy is not None,
           "generated graph: no tier 2 or no heavy class")
    ((d_e, u_e),) = ell_natural(dg, se, mesh, mask_ext[:-1])
    _equal(d_e, d_ref, "ELL depth")
    _equal(u_e, u_ref, "ELL uniq")
    masks = torch.from_numpy(
        rng.integers(0, 2, (Q_BATCH, n_paths)).astype(np.int32)
    ).to(device)
    for q, (d_b, u_b) in enumerate(ell_natural(dg, se, mesh, masks, batch=True)):
        d_q, u_q = depth_op.seg_depth_with_uniq_masked(dg, masks[q].bool())
        _equal(d_b, d_q, f"batched ELL depth, query {q}")
        _equal(u_b, u_q, f"batched ELL uniq, query {q}")
    return {"classes": classes, "straddles": straddles}


def _dryrun_rank(rank: int, world: int, device: torch.device) -> dict:
    from . import sharded

    mesh = sharded.make_mesh()
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    out.update(_tiny_phase(mesh, device))
    out.update(_generated_phase(mesh, device))
    out["foreign_modules"] = foreign_modules()
    flags = all_gather(torch.tensor([len(out["foreign_modules"])], device=device))
    _check(int(flags.sum()) == 0, f"a rank loaded JAX or pollen_tpu: {out}")
    return out


def dryrun_multichip(
    n_devices: int, device: str = "cuda", deadline: float = 600.0
) -> list:
    """Spawn ``n_devices`` ranks and run every sharded query on them (see
    the module's docstring); raises at the first check that fails, or at
    the deadline. Returns each rank's summary. Needs 2 ranks or more: a
    (segment, path) group must straddle a chunk bound."""
    if n_devices < 2:
        raise ValueError(
            f"the dry run needs 2 ranks or more (a chunk bound for a group to "
            f"straddle), got {n_devices}"
        )
    results = launch.run(_dryrun_rank, n_devices, device=device,
                         deadline=deadline)
    r0 = results[0]
    print(
        f"dryrun_multichip OK on {n_devices} ranks ({device}, mesh "
        f"{r0['mesh']}): tiny fixture depth={r0['depth']}, "
        f"degree={r0['degree']}; generated graph S=2^20 N=2^16 P=128 "
        f"(ELL classes l/m/h/e={r0['classes']}, {r0['straddles']} "
        f"straddling chunk bounds) verified sharded forms: cumsum scan, "
        f"fused scan on K6 (device look-back carry), scatter output, "
        f"crossing matrix, tiered ELL (t1+t2+heavy), batched tiered ELL "
        f"(Q={Q_BATCH}), degree; all equal the single-device query",
        flush=True,
    )
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pollen_tpu_torch.parallel.dryrun")
    ap.add_argument("n", type=int, nargs="?", default=8, help="ranks (default 8)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
