"""The ELL family's one-call yardstick (pollen_tpu_torch.probes.yardstick:
one torch.sparse.mm of CSR counts by the masks) against the kernels'
plain versions on the CPU: generated split indexes (pack16 and 32-bit
slots, 1-3 tiers with and without a heavy block, Q = 1 and 3), one tall
tier and flat slots (the K3 and K9 forms), and the index of small
synthetic graphs. Exact: every sum is an integer below 2^24."""

import numpy as np
import pytest
import torch

from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.kernels import ellscan as ell
from pollen_tpu_torch.probes import yardstick as ys
from pollen_tpu_torch.synth import synth_graph

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings(
    "ignore:Sparse CSR tensor support is in beta:UserWarning")


def _flat(rng, slots, n, p, max_count):
    """Random int32[slots, n] path<<16|count slots over p paths, 30%
    empty."""
    v = (rng.integers(0, p, (slots, n)) << 16) | rng.integers(
        1, max_count + 1, (slots, n))
    v[rng.random(v.shape) < 0.3] = 0
    return (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _tier(rng, k, n, p, pack16):
    """A tall tier of k stored words a column (pack16: 2k slots)."""
    flat = _flat(rng, 2 * k if pack16 else k, n, p, 255 if pack16 else 0xFFFF)
    if pack16:
        flat = ell.pair_ell16(flat)
    return torch.from_numpy(ell.pack_ell_tall(flat))


def _product(csr, cols, masks):
    return ys.depth_uniq(ys.ell_yardstick(csr, ys.masks_for(masks)), cols)


def _columns(parts):
    """Per-class (depth, uniq) outputs -> (Q, columns) depth and uniq."""
    parts = [x if x.dim() == 2 else x[None] for x in parts if x is not None]
    return torch.cat(parts[0::2], 1), torch.cat(parts[1::2], 1)


@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("n_tiers", [1, 2, 3])
@pytest.mark.parametrize("pack16", [False, True])
def test_yardstick_equals_split_plain(pack16, n_tiers, heavy, q):
    rng = np.random.default_rng(100 * n_tiers + 10 * q + heavy + pack16)
    p = 200 if pack16 else 3000
    ks = [1, 3, 5][:n_tiers]
    tiers = [_tier(rng, k, 900, p, pack16) for k in ks]
    block = torch.from_numpy(
        rng.integers(0, 256, (-(-p // 2), 256 if heavy else 0)).astype(np.uint8))
    masks = torch.from_numpy(rng.random((q, p)) < 0.5)
    csr, cols = ys.ell_csr(p, tiers, ks, pack16, heavy=block)
    d, u = _product(csr, cols, masks)
    want = ell.masked_ell_splitn_depth_batch_plain(tiers, block, masks, ks,
                                                   pack16)
    wd, wu = _columns(want)
    assert torch.equal(d, wd) and torch.equal(u, wu)
    if q == 1:  # the single-query plain version too
        wd, wu = _columns(ell.masked_ell_splitn_depth_plain(
            tiers, block, masks[0], ks, pack16))
        assert torch.equal(d, wd) and torch.equal(u, wu)


@pytest.mark.parametrize("form", ["tall tier", "flat slots"])
def test_yardstick_equals_tier_and_flat_plain(form):
    rng = np.random.default_rng(3)
    p = 40000  # path ids past 2^15
    masks = torch.from_numpy(rng.random((2, p)) < 0.5)
    if form == "tall tier":
        tall = _tier(rng, 2, 5000, p, False)
        csr, cols = ys.ell_csr(p, [tall], [2])
        want = [ell.masked_ell_depth_tall_plain(tall, m, 2) for m in masks]
    else:
        flat = torch.from_numpy(_flat(rng, 3, 1024, p, 0xFFFF))
        csr, cols = ys.ell_csr(p, flat=flat)
        want = [ell.masked_ell_depth_plain(flat, m) for m in masks]
    d, u = _product(csr, cols, masks)
    assert torch.equal(d, torch.stack([w[0] for w in want]))
    assert torch.equal(u, torch.stack([w[1] for w in want]))


def test_yardstick_leaves_out_paths_past_the_mask():
    """Cells of paths past the mask count 0, as in the plain versions."""
    rng = np.random.default_rng(4)
    tall = _tier(rng, 2, 700, 300, False)
    block = torch.from_numpy(rng.integers(0, 256, (150, 128)).astype(np.uint8))
    masks = torch.ones((2, 100), dtype=torch.int32)
    csr, cols = ys.ell_csr(100, [tall], [2], heavy=block)
    d, u = _product(csr, cols, masks)
    wd, wu = _columns(ell.masked_ell_splitn_depth_batch_plain(
        [tall], block, torch.nn.functional.pad(masks, (0, 200)), [2]))
    assert torch.equal(d, wd) and torch.equal(u, wu)


@pytest.mark.parametrize("n_paths", [100, 300])
def test_yardstick_on_synthetic_graph(n_paths):
    """The index build_graph makes for a small synthetic graph."""
    dg = build_graph(synth_graph(2**15, 2**11, n_paths), "cpu")
    tiers = [t for t in (dg.cross_ell, dg.cross_ell2, dg.cross_ell3) if t.numel()]
    ks = [k for k in (dg.ell_k, dg.ell_k2, dg.ell_k3) if k]
    rng = np.random.default_rng(n_paths)
    masks = torch.from_numpy(rng.random((3, n_paths)) < 0.5)
    p16 = bool(dg.ell_pack16)
    csr, cols = ys.ell_csr(n_paths, tiers, ks, p16, heavy=dg.ell_heavy)
    d, u = _product(csr, cols, masks)
    wd, wu = _columns(ell.masked_ell_splitn_depth_batch_plain(
        tiers, dg.ell_heavy, masks, ks, p16))
    assert torch.equal(d, wd) and torch.equal(u, wu)


def test_yardstick_needs_cells():
    with pytest.raises(ValueError, match="needs"):
        ys.ell_csr(10)
