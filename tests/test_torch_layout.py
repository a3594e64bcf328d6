"""The readers of the resident index's layout (``pollen_tpu_torch/device.py``)
against plain numpy counts on the CPU: the clip-residual sum and its
scatter under one mask or Q masks, into a whole answer or into a rank's
slice of it, for a nibble (clip 15) and an int8 (clip 127) sidecar with
sentinel columns; and the tiered ELL composition, whose single-device
and sharded callers agree with each other and with a count of the steps
on a generated graph of three tiers, a heavy class with clip overflow
and never-crossed segments. All comparisons are exact.
"""

import numpy as np
import pytest
import torch

from pollen_tpu_torch.device import (
    add_residual,
    build_graph,
    ell_tiers,
    residual_sums,
)
from pollen_tpu_torch.flatgfa import GraphArrays
from pollen_tpu_torch.kernels import crossmat as cm
from pollen_tpu_torch.kernels import ellscan as port_ellscan
from pollen_tpu_torch.ops import depth as port_depth
from pollen_tpu_torch.parallel import launch
from pollen_tpu_torch.parallel import sharded as port_sh

torch.set_num_threads(1)

N, N_PAD, P, P_PAD = 1000, 1024, 200, 256
WIDTH = 384  # a rank's columns: rank 1 of 3 holds [384, 768)


def _sidecar(rng, clip):
    """Seeded unique (path, segment) runs, one in five past ``clip``, as
    dense counts int64[P_PAD, N_PAD] and the ingest's sidecar of them:
    int32[P_PAD, K] residuals past the clip and the K column ids, padded
    to a multiple of 128 with RES_SENTINEL."""
    pairs = rng.choice(P * N, size=3000, replace=False)
    path, seg = pairs // N, pairs % N
    count = rng.integers(1, clip + 1, pairs.size)
    over = rng.random(pairs.size) < 0.2
    count[over] = rng.integers(clip + 1, 4 * clip, int(over.sum()))
    dense = np.zeros((P_PAD, N_PAD), np.int64)
    dense[path, seg] = count
    segs = np.unique(seg[over])
    k_pad = -(-segs.size // 128) * 128
    res = np.zeros((P_PAD, k_pad), np.int32)
    res[path[over], np.searchsorted(segs, seg[over])] = count[over] - clip
    cols = np.full(k_pad, cm.RES_SENTINEL, np.int32)
    cols[: segs.size] = segs
    return dense, res, cols


@pytest.mark.parametrize("clip", [cm.CLIP_NIBBLE, cm.CLIP], ids=["nibble", "int8"])
@pytest.mark.parametrize("lo", [0, WIDTH], ids=["whole", "rank"])
@pytest.mark.parametrize("q", [None, 5], ids=["one_mask", "q_masks"])
def test_residual_scatter_matches_numpy_count(clip, lo, q):
    """The clipped answer plus the residual (its sums under the masks,
    scattered at the sidecar's columns) is the count of the unclipped
    runs; sentinel columns and, in a rank's slice, the columns of other
    ranks add nothing."""
    rng = np.random.default_rng(clip + lo + (q or 0))
    dense, res, cols = _sidecar(rng, clip)
    real = cols[cols != cm.RES_SENTINEL]
    assert real.size < cols.size  # sentinel padding present
    if lo:  # residual columns of the ranks on both sides
        assert (real < lo).any() and (real >= lo + WIDTH).any()
    masks = np.zeros((q or 1, P_PAD), np.int32)
    masks[:, :P] = rng.random((q or 1, P)) < 0.5
    clipped = masks @ np.minimum(dense, clip)
    truth = masks @ dense
    width = WIDTH if lo else N_PAD
    m = torch.from_numpy(masks if q else masks[0])
    fix = residual_sums(torch.from_numpy(res), m)
    assert fix.dtype == torch.int32
    assert np.array_equal(fix.numpy(), (masks @ res)[0 if q is None else slice(None)])
    out = torch.from_numpy(clipped[..., lo : lo + width].astype(np.int32))
    got = add_residual(out if q else out[0], fix, torch.from_numpy(cols), lo)
    assert got.dtype == torch.int32
    want = truth[..., lo : lo + width]
    assert np.array_equal(got.numpy(), want if q else want[0])


def layout_graph(n1=40000, n2=40000, n3=20000, nh=200, ne=37, p=64, over=20):
    """Runs per segment 1, 4, 16 and 40 by block, then ``ne`` segments no
    path crosses; every other segment of the last block is crossed
    ``over`` times by one path. With the fixed and per-column costs
    zeroed the planner picks three tiers, a heavy class with clip
    overflow and an empty class."""
    n = n1 + n2 + n3 + nh + ne
    segs, paths = [], []
    for base, count, r in (
        (0, n1, 1), (n1, n2, 4), (n1 + n2, n3, 16), (n1 + n2 + n3, nh, 40)
    ):
        s = np.arange(base, base + count, dtype=np.int64)
        for i in range(r):
            segs.append(s)
            paths.append((s + i) % p)
    hv = np.arange(n1 + n2 + n3, n1 + n2 + n3 + nh, 2, dtype=np.int64)
    segs += [hv] * (over - 1)
    paths += [hv % p] * (over - 1)
    seg, pth = np.concatenate(segs), np.concatenate(paths)
    order = np.argsort(pth, kind="stable")
    seg, pth = seg[order], pth[order]
    bounds = np.concatenate(
        ([0], np.cumsum(np.bincount(pth, minlength=p)))
    ).astype(np.uint32)
    sb = np.arange(n + 1, dtype=np.uint32)
    names = [f"t{i}".encode() for i in range(p)]
    ends = np.cumsum([len(b) for b in names]).astype(np.uint32)
    none2 = np.zeros((0, 2), np.uint32)
    return GraphArrays(
        header=np.zeros(0, np.uint8),
        seg_name=np.arange(1, n + 1, dtype=np.int64),
        seg_seq=np.stack([sb[:-1], sb[1:]], axis=1),
        seg_optional=np.zeros((n, 2), np.uint32),
        path_name=np.stack([np.concatenate(([0], ends[:-1])), ends], axis=1)
        .astype(np.uint32),
        path_steps=np.stack([bounds[:-1], bounds[1:]], axis=1),
        path_overlaps=np.zeros((p, 2), np.uint32),
        link_from=np.zeros(0, np.uint32),
        link_to=np.zeros(0, np.uint32),
        link_overlap=none2,
        steps=(seg.astype(np.uint32) << np.uint32(1)),
        seq_data=np.zeros(n, np.uint8),
        overlaps=none2,
        alignment=np.zeros(0, np.uint32),
        name_data=np.frombuffer(b"".join(names), np.uint8).copy(),
        optional_data=np.zeros(0, np.uint8),
        line_order=np.zeros(0, np.uint8),
    )


@pytest.fixture(scope="module")
def layout():
    """(graph, its index, seeded (3, P) bool masks, numpy (depth, uniq)
    of shape (3, N) under them)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_ellscan, "C_TIER_FIXED", 0.0)
        mp.setattr(port_ellscan, "C_COL_B", 0.0)
        g = layout_graph()
        dg = build_graph(g, "cpu")
    counts = np.zeros((g.num_paths, g.num_segments), np.int32)
    np.add.at(counts, (g.step_path_ids(), g.step_segs), 1)
    masks = np.random.default_rng(7).random((3, g.num_paths)) < 0.5
    truth = masks.astype(np.int32) @ counts, masks.astype(np.int32) @ (counts > 0)
    return g, dg, masks, truth


def test_layout_graph_has_every_class(layout):
    """Three tiers, a heavy block with clip-overflow columns, an empty
    class, and the classes partition the N segments."""
    g, dg, _, _ = layout
    assert len(ell_tiers(dg)) == 3
    assert dg.ell_num_heavy and dg.ell_heavy_res_col.numel()
    classes = (dg.ell_num_light, dg.ell_num_mid, dg.ell_num_mid2, dg.ell_num_heavy)
    assert all(classes) and sum(classes) < g.num_segments
    assert sorted(dg.ell_order.tolist()) == list(range(g.num_segments))


@pytest.mark.parametrize("form", ["single", "batch"])
def test_ell_composition_single_and_sharded_agree(layout, form):
    """The single-device ELL query (its tiers 2 and 3 folded into one mid
    class) and a one-rank sharded query (every tier its own part)
    composed by ``compose_ell_parts_natural`` give the numpy count."""
    g, dg, masks, (d_want, u_want) = layout
    m32 = torch.from_numpy(masks.astype(np.int32))
    with launch.world_of_one("cpu"):
        mesh = port_sh.make_mesh()
        se = port_sh.shard_ell_inputs(dg, mesh)
        has = dict(has_mid=se.ell2 is not None, has_mid2=se.ell3 is not None,
                   has_heavy=se.heavy is not None)
        assert all(has.values())
        if form == "single":
            fn = port_sh.sharded_ell_depth_fn(mesh, **has)
            sharded = [fn(*port_sh.ell_args(se, m32[i])) for i in range(len(masks))]
        else:
            fn = port_sh.sharded_ell_depth_batch_fn(mesh, **has)
            parts = fn(*port_sh.ell_args(se, m32))
            sharded = [[x[i] for x in parts] for i in range(len(masks))]
    if form == "single":
        single = [port_depth.seg_depth_with_uniq_ell(dg, torch.from_numpy(m), plain=True)
                  for m in masks]
        single = [(d.numpy(), u.numpy()) for d, u in single]
    else:
        d_b, u_b = port_depth.seg_depth_with_uniq_ell_batch(dg, torch.from_numpy(masks),
                                                            plain=True)
        single = list(zip(d_b, u_b))
    for i, parts in enumerate(sharded):
        d_sh, u_sh = port_sh.compose_ell_parts_natural(dg, parts, **has)
        assert d_sh.dtype == u_sh.dtype == np.int64
        assert single[i][0].dtype == np.int32
        for got in (d_sh, single[i][0]):
            assert np.array_equal(got, d_want[i])
        for got in (u_sh, single[i][1]):
            assert np.array_equal(got, u_want[i])


def test_ell_permuted_is_the_count_in_ell_order(layout):
    """The permuted form stays on the device, in ``ell_order``."""
    _, dg, masks, (d_want, u_want) = layout
    order = dg.ell_order.numpy()
    d, u = port_depth.seg_depth_with_uniq_ell_permuted(
        dg, torch.from_numpy(masks[0]), plain=True
    )
    assert d.dtype == u.dtype == torch.int32
    assert np.array_equal(d.numpy(), d_want[0][order])
    assert np.array_equal(u.numpy(), u_want[0][order])


@pytest.mark.parametrize("tiers,scale", [(1, 4), (2, 2), (3, 1)])
def test_ell_routes_count_at_each_tier_count(tiers, scale):
    """The single and batched ELL queries on indexes of one, two and
    three tiers (the mid class absent, tier 2 alone, tiers 2 and 3
    folded) equal the numpy count."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_ellscan, "C_TIER_FIXED", 0.0)
        mp.setattr(port_ellscan, "C_COL_B", 0.0)
        g = layout_graph(40000 // scale, 40000 // scale, 20000 // scale)
        dg = build_graph(g, "cpu")
    assert len(ell_tiers(dg)) == tiers
    counts = np.zeros((g.num_paths, g.num_segments), np.int32)
    np.add.at(counts, (g.step_path_ids(), g.step_segs), 1)
    masks = np.random.default_rng(tiers).random((2, g.num_paths)) < 0.5
    d_want = masks.astype(np.int32) @ counts
    u_want = masks.astype(np.int32) @ (counts > 0)
    d_b, u_b = port_depth.seg_depth_with_uniq_ell_batch(dg, torch.from_numpy(masks),
                                                        plain=True)
    assert np.array_equal(d_b, d_want) and np.array_equal(u_b, u_want)
    d, u = port_depth.seg_depth_with_uniq_ell(dg, torch.from_numpy(masks[1]), plain=True)
    assert np.array_equal(d.numpy(), d_want[1]) and np.array_equal(u.numpy(), u_want[1])
