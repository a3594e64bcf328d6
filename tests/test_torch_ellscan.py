"""Port ELL module (pollen_tpu_torch.kernels.ellscan) against the JAX
reference: host planner and packers, the plain tier reduction, and the
kernel wrappers' CPU path against the Pallas kernels in interpret mode.
All comparisons are exact (integer counts, tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pollen_tpu.kernels import ellscan as ref
from pollen_tpu_torch.kernels import ellscan as port

torch.set_num_threads(1)


def _slots(rng, k, n, max_path, max_count=0xFFFF, empty=0.3):
    """Random int32[k, n] path<<16|count slots, some empty (0)."""
    path = rng.integers(0, max_path, (k, n))
    cnt = rng.integers(1, max_count + 1, (k, n))
    v = ((path << 16) | cnt).astype(np.int64)
    v[rng.random((k, n)) < empty] = 0
    return (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def test_constants_match_reference():
    for name in (
        "COUNT_BITS",
        "COUNT_MAX",
        "C_COL_B",
        "C_HEAVY_PER_PATH",
        "C_HEAVY_PER_BYTE",
        "C_TIER_FIXED",
        "ELL_BATCH_Q",
        "SUB",
        "TALL_W",
    ):
        assert getattr(port, name) == getattr(ref, name), name
    for n_words in (1, 3, 4, 9, 2048):
        assert port.c_slot_a(n_words) == ref.c_slot_a(n_words)


@pytest.mark.parametrize("objective", ["single", "batch"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_ell_tiers_matches_reference(seed, objective):
    rng = np.random.default_rng(seed)
    n = 200_000
    runs = np.minimum(rng.zipf(1.6, n) - 1, 80)
    big = rng.random(n) < 0.01
    for p_pad in (128, 384):
        ks_r, masks_r, heavy_r = ref.plan_ell_tiers_n(
            runs, big, p_pad, objective=objective
        )
        ks_p, masks_p, heavy_p = port.plan_ell_tiers_n(
            runs, big, p_pad, objective=objective
        )
        assert ks_p == ks_r
        assert len(masks_p) == len(masks_r)
        for a, b in zip(masks_r, masks_p):
            assert np.array_equal(a, b)
        assert np.array_equal(heavy_r, heavy_p)


def test_plan_ell_tiers_all_heavy():
    runs = np.array([0, 50, 60])
    big = np.zeros(3, bool)
    assert port.plan_ell_tiers_n(runs, big, 128)[0] == ()
    assert np.array_equal(
        port.plan_ell_tiers_n(runs, big, 128)[2],
        ref.plan_ell_tiers_n(runs, big, 128)[2],
    )


def test_packers_match_reference():
    rng = np.random.default_rng(3)
    n_runs, n_cols, k = 500, 300, 4
    col = rng.integers(0, n_cols, n_runs)
    slot = rng.integers(0, k, n_runs)
    key = np.unique(col * k + slot)
    col, slot = key // k, key % k
    path = rng.integers(0, 256, col.size)
    cnt = rng.integers(1, 256, col.size)
    e_r = ref.pack_ell(path, cnt, col, slot, k, n_cols)
    e_p = port.pack_ell(path, cnt, col, slot, k, n_cols)
    assert np.array_equal(e_r, e_p)
    for kk in (3, 4):
        pr = ref.pair_ell16(e_r[:kk])
        pp = port.pair_ell16(e_p[:kk])
        assert pp.dtype == np.int32 and np.array_equal(pr, pp)
        un_r = np.asarray(ref.unpair_ell16(pr))
        un_p = port.unpair_ell16(torch.from_numpy(pp)).numpy()
        assert np.array_equal(un_r, un_p)
    tall_r = ref.pack_ell_tall(e_r)
    tall_p = port.pack_ell_tall(e_p)
    assert np.array_equal(tall_r, tall_p)
    flat = port.unfold_ell_tall(torch.from_numpy(tall_p), k).numpy()
    assert np.array_equal(flat, np.asarray(ref.unfold_ell_tall(tall_r, k)))
    assert np.array_equal(flat[:, :n_cols], e_p)


def test_pair_ell16_refuses_wide_values():
    e = np.array([[(300 << 16) | 1]], np.int32)
    with pytest.raises(ValueError):
        port.pair_ell16(e)


@pytest.mark.parametrize("n_paths", [1, 31, 32, 33, 64, 96, 300, 65535])
def test_pack_mask_words_matches_reference(n_paths):
    rng = np.random.default_rng(n_paths)
    mask = rng.integers(0, 2, n_paths).astype(np.int32)
    mask[-1] = 1  # bit 31 of the last word where it lands there
    n_words = -(-n_paths // 32)
    w_r = np.asarray(ref.pack_mask_words(jnp.asarray(mask), n_words))
    w_p = port.pack_mask_words(torch.from_numpy(mask), n_words).numpy()
    assert w_p.dtype == np.int32 and np.array_equal(w_r, w_p)


@pytest.mark.parametrize("max_path", [256, 40000, 65536])
def test_masked_ell_depth_plain_matches_xla(max_path):
    """Paths >= 2^15 set the slot word's sign bit: the shifts must not
    sign-extend."""
    rng = np.random.default_rng(max_path)
    ell = _slots(rng, 5, 700, max_path)
    mask = rng.integers(0, 2, max_path).astype(np.int32)
    d_r, u_r = ref.masked_ell_depth_xla(jnp.asarray(ell), jnp.asarray(mask))
    d_p, u_p = port.masked_ell_depth_plain(
        torch.from_numpy(ell), torch.from_numpy(mask)
    )
    assert d_p.dtype == torch.int32 and u_p.dtype == torch.int32
    assert np.array_equal(np.asarray(d_r), d_p.numpy())
    assert np.array_equal(np.asarray(u_r), u_p.numpy())


def _tall_tier(rng, k, n_cols, max_path, pack16):
    flat = _slots(rng, k, n_cols, max_path, 255 if pack16 else 0xFFFF)
    if pack16:
        flat = ref.pair_ell16(flat)
        k = flat.shape[0]
    return ref.pack_ell_tall(flat), k


def test_ell_tall_wrapper_matches_pallas_interpret():
    rng = np.random.default_rng(11)
    tall, k = _tall_tier(rng, 2, 5000, 40000, pack16=False)
    mask = rng.integers(0, 2, 40000).astype(np.int32)
    d_r, u_r = ref.masked_ell_depth_tall(
        jnp.asarray(tall), jnp.asarray(mask), k=k, interpret=True
    )
    before = dict(port.launches)
    d_p, u_p = port.masked_ell_depth_tall(
        torch.from_numpy(tall), torch.from_numpy(mask), k
    )
    assert port.launches == before  # the CPU path launches no kernel
    assert np.array_equal(np.asarray(d_r), d_p.numpy())
    assert np.array_equal(np.asarray(u_r), u_p.numpy())


@pytest.mark.parametrize("pack16", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 9, 17])
def test_ell_tall_wrapper_matches_reference_at_k(k, pack16):
    """The tall wrapper (CPU path: its plain version) at stored-word
    counts across the kernel's chunks of 1, 2, 4 and 8 words, on three
    row groups: 32-bit tiers against the reference's
    masked_ell_depth_tall, pack16 tiers against its
    masked_ell_splitn_depth with no heavy class (its tall kernel has no
    pack16 body, and its query routes a pack16 tier there), both in
    interpret mode."""
    rng = np.random.default_rng(100 + k)
    p = 200 if pack16 else 300
    n_cols = 3 * port.SUB * port.TALL_W - 100
    tall, kw = _tall_tier(rng, 2 * k if pack16 else k, n_cols, p, pack16)
    assert kw == k and tall.shape == (3 * k * port.SUB, port.TALL_W)
    mask = rng.integers(0, 2, p).astype(np.int32)
    if pack16:
        want = ref.masked_ell_splitn_depth(
            (jnp.asarray(tall),), jnp.zeros((0, 0), jnp.uint8),
            jnp.asarray(mask), ks=(k,), interpret=True, pack16=True,
        )
    else:
        want = ref.masked_ell_depth_tall(
            jnp.asarray(tall), jnp.asarray(mask), k=k, interpret=True
        )
    got = port.masked_ell_depth_tall(
        torch.from_numpy(tall), torch.from_numpy(mask), k, pack16
    )
    assert len(want) == len(got) == 2
    for a, b in zip(want, got):
        assert b.dtype == torch.int32
        assert np.array_equal(np.asarray(a), b.numpy())


def test_ell_splitn_wrapper_matches_pallas_interpret():
    """pack16 tiers plus a nibble heavy block, one fused call."""
    rng = np.random.default_rng(12)
    p = 200
    t1, k1 = _tall_tier(rng, 2, 3000, p, pack16=True)
    t2, k2 = _tall_tier(rng, 5, 700, p, pack16=True)
    heavy = rng.integers(0, 256, (128, 256)).astype(np.uint8)
    mask = rng.integers(0, 2, p).astype(np.int32)
    outs_r = ref.masked_ell_splitn_depth(
        (jnp.asarray(t1), jnp.asarray(t2)),
        jnp.asarray(heavy),
        jnp.asarray(mask),
        ks=(k1, k2),
        interpret=True,
        pack16=True,
    )
    outs_p = port.masked_ell_splitn_depth(
        [torch.from_numpy(t1), torch.from_numpy(t2)],
        torch.from_numpy(heavy),
        torch.from_numpy(mask),
        ks=[k1, k2],
        pack16=True,
    )
    assert len(outs_p) == len(outs_r) == 6
    for a, b in zip(outs_r, outs_p):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("pack16", [False, True])
def test_ell_splitn_cpu_equals_per_tier(pack16):
    """The fused wrapper's tiers equal the tall wrapper's, three tiers
    and no heavy class."""
    rng = np.random.default_rng(13)
    p = 250 if pack16 else 3000
    tiers = [_tall_tier(rng, k, n, p, pack16) for k, n in ((1, 900), (3, 400), (7, 50))]
    mask = torch.from_numpy(rng.integers(0, 2, p).astype(np.int32))
    outs = port.masked_ell_splitn_depth(
        [torch.from_numpy(t) for t, _ in tiers],
        torch.zeros((0, 0), dtype=torch.uint8),
        mask,
        ks=[k for _, k in tiers],
        pack16=pack16,
    )
    assert len(outs) == 6
    for i, (t, k) in enumerate(tiers):
        d, u = port.masked_ell_depth_tall(torch.from_numpy(t), mask, k, pack16)
        assert torch.equal(outs[2 * i], d) and torch.equal(outs[2 * i + 1], u)


@pytest.mark.parametrize("n_paths", [1, 33, 300])
def test_pack_mask_words_batch_matches_reference(n_paths):
    rng = np.random.default_rng(n_paths)
    masks = rng.integers(0, 2, (5, n_paths)).astype(np.int32)
    masks[:, -1] = 1
    w_r = np.asarray(ref.pack_mask_words_batch(jnp.asarray(masks)))
    w_p = port.pack_mask_words_batch(torch.from_numpy(masks)).numpy()
    assert w_p.dtype == np.int32 and np.array_equal(w_r, w_p)


_T1 = ((2, 3000),)
_T2 = ((1, 3000), (4, 700))
_T3 = ((1, 900), (3, 400), (5, 50))


@pytest.mark.parametrize(
    "spec,heavy_rows,pack16,q,ref_fn",
    [
        (_T1, 64, True, 1, "fused"),
        (_T1, 0, False, 16, "split"),
        (_T2, 64, True, 16, "fused"),
        (_T2, 64, False, 5, "split"),
        (_T3, 0, True, 5, "fused"),
        (_T3, 64, False, 16, "split"),
    ],
)
def test_ell_splitn_batch_wrapper_matches_pallas_interpret(
    spec, heavy_rows, pack16, q, ref_fn
):
    """The batched split wrapper's CPU path against the fused Pallas
    batch kernel and its per-tier split emission (interpret mode): 1-3
    tiers, with and without the heavy block, pack16 and 32-bit slots."""
    rng = np.random.default_rng(len(spec) * 100 + q)
    p = 120
    tiers = [_tall_tier(rng, k, n, p, pack16) for k, n in spec]
    heavy = rng.integers(0, 256, (heavy_rows, 256 if heavy_rows else 0))
    heavy = heavy.astype(np.uint8)
    masks = rng.integers(0, 2, (q, p)).astype(np.int32)
    masks[0] = 1
    fn = {
        "fused": ref.masked_ell_splitn_depth_batch,
        "split": ref.masked_ell_splitn_depth_batch_split,
    }[ref_fn]
    outs_r = fn(
        tuple(jnp.asarray(t) for t, _ in tiers),
        jnp.asarray(heavy),
        jnp.asarray(masks),
        ks=tuple(k for _, k in tiers),
        interpret=True,
        pack16=pack16,
    )
    before = dict(port.launches)
    outs_p = port.masked_ell_splitn_depth_batch(
        [torch.from_numpy(t) for t, _ in tiers],
        torch.from_numpy(heavy),
        torch.from_numpy(masks),
        ks=[k for _, k in tiers],
        pack16=pack16,
    )
    assert port.launches == before  # the CPU path launches no kernel
    assert len(outs_p) == len(outs_r) == 2 * len(spec) + 2
    assert (outs_p[-1] is None) == (heavy_rows == 0)
    for a, b in zip(outs_r, outs_p):
        assert (a is None) == (b is None)
        if a is not None:
            assert b.dtype == torch.int32 and b.shape[0] == q
            assert np.array_equal(np.asarray(a), b.numpy())


def test_ell_splitn_batch_rows_equal_single_query():
    """Each row of the batch equals the single-query wrapper's answer."""
    rng = np.random.default_rng(14)
    p = 300
    tiers = [_tall_tier(rng, k, n, p, False) for k, n in _T2]
    heavy = torch.from_numpy(
        rng.integers(0, 256, (192, 384)).astype(np.uint8)
    )
    masks = torch.from_numpy(rng.random((3, p)) < 0.5)
    args = [torch.from_numpy(t) for t, _ in tiers], heavy
    ks = [k for _, k in tiers]
    batch = port.masked_ell_splitn_depth_batch(*args, masks, ks)
    for i, m in enumerate(masks):
        single = port.masked_ell_splitn_depth(*args, m, ks)
        for b, s in zip(batch, single):
            assert torch.equal(b[i], s)


def test_batch_wrapper_checks_inputs():
    tall = torch.zeros((port.SUB, port.TALL_W), dtype=torch.int32)
    empty = torch.zeros((0, 0), dtype=torch.uint8)
    with pytest.raises(ValueError, match="Q >= 1"):
        port.masked_ell_splitn_depth_batch(
            [tall], empty, torch.ones(8, dtype=torch.int32), ks=[1]
        )
    with pytest.raises(ValueError, match="Q >= 1"):
        port.masked_ell_splitn_depth_batch(
            [tall], empty, torch.ones((0, 8), dtype=torch.int32), ks=[1]
        )
    with pytest.raises(ValueError, match="no kernel"):
        port.masked_ell_splitn_depth_batch(
            [tall.to("meta")], empty.to("meta"),
            torch.ones((2, 8), dtype=torch.int32, device="meta"), ks=[1],
        )


def test_wrappers_check_inputs():
    mask = torch.ones(8, dtype=torch.int32)
    tall = torch.zeros((port.SUB, port.TALL_W), dtype=torch.int32)
    with pytest.raises(TypeError):
        port.masked_ell_depth_tall(tall.to(torch.int64), mask, 1)
    with pytest.raises(ValueError):
        port.masked_ell_depth_tall(tall, mask, 3)  # rows do not fit k
    with pytest.raises(ValueError):
        port.masked_ell_depth_tall(tall.t().contiguous().t(), mask, 1)
    with pytest.raises(ValueError, match="no kernel"):
        port.masked_ell_depth_tall(tall.to("meta"), mask.to("meta"), 1)
    with pytest.raises(ValueError, match="no kernel"):
        port.masked_ell_splitn_depth(
            [tall.to("meta")], torch.zeros((0, 0), dtype=torch.uint8,
                                           device="meta"),
            mask.to("meta"), ks=[1],
        )
    with pytest.raises(ValueError):
        port.masked_ell_splitn_depth(
            [tall] * 4, torch.zeros((0, 0), dtype=torch.uint8), mask,
            ks=[1] * 4,
        )
    with pytest.raises(ValueError, match="SUB"):
        port.check_ell_sub(port.SUB + 1)


@pytest.mark.parametrize(
    "q,n_paths,words",
    [
        (32, 0, 0),
        (65, 4096, 0),  # the bits of 4096 paths are built in each block
        (1, 4097, 129 * 32 + 129),  # one chunk's path-major bits + 1 query
        (33, 40000, 2 * 1250 * 32 + 33 * 1250),  # two chunks, 33 queries
    ],
)
def test_batch_scratch_words(q, n_paths, words):
    """The batched split kernel's scratch: none up to 4096 paths, else
    each 32-query chunk's path-major bits and each query's bit words."""
    assert port.batch_scratch_words(q, n_paths) == words


def test_splitn_refuses_misaligned_tiers():
    """The fused kernels load four tier columns as one 16-byte word."""
    n = port.SUB * port.TALL_W
    tall = torch.zeros(n + 1, dtype=torch.int32)[1:].view(port.SUB, port.TALL_W)
    assert tall.is_contiguous() and tall.data_ptr() % 16
    empty = torch.zeros((0, 0), dtype=torch.uint8)
    with pytest.raises(ValueError, match="16-byte"):
        port.masked_ell_splitn_depth([tall], empty, torch.ones(8), ks=[1])
    with pytest.raises(ValueError, match="16-byte"):
        port.masked_ell_splitn_depth_batch(
            [tall], empty, torch.ones((2, 8)), ks=[1]
        )


def test_tall_refuses_misaligned_tier():
    """The tall kernel loads four columns as one 16-byte word too: the
    wrapper raises on any device rather than take the plain version."""
    n = port.SUB * port.TALL_W
    tall = torch.zeros(n + 1, dtype=torch.int32)[1:].view(port.SUB, port.TALL_W)
    assert tall.is_contiguous() and tall.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        port.masked_ell_depth_tall(tall, torch.ones(8), 1)


def test_splitn_heavy_block_alone():
    """Tiers of no columns (the heavy phase launched alone): empty tier
    outputs, heavy outputs as in the whole call."""
    rng = np.random.default_rng(15)
    p = 120
    tall, k = _tall_tier(rng, 2, 3000, p, pack16=True)
    tall = torch.from_numpy(tall)
    heavy = torch.from_numpy(rng.integers(0, 256, (64, 256)).astype(np.uint8))
    masks = torch.from_numpy(rng.random((3, p)) < 0.5)
    whole = port.masked_ell_splitn_depth_batch([tall], heavy, masks, [k], True)
    alone = port.masked_ell_splitn_depth_batch([tall[:0]], heavy, masks, [k],
                                               True)
    assert alone[0].shape == alone[1].shape == (3, 0)
    assert torch.equal(alone[2], whole[2]) and torch.equal(alone[3], whole[3])
    single = port.masked_ell_splitn_depth([tall[:0]], heavy, masks[0], [k], True)
    assert single[0].numel() == 0
    assert torch.equal(single[2], whole[2][0])
