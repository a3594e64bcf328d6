"""The flat ELL kernel's multi-tier entry (K9, ``masked_ell_depth_tiers``)
on the CPU: each tier's (depth, uniq) from the wrapper's plain path
against the reference's ``masked_ell_depth`` run on that tier alone, the
Pallas kernel in interpret mode; 1-3 tiers at ragged column counts
(128, 1152 and 294,912 + 128: a last 1,024-column tile cut short), k =
1, 2, 3, 5, 9 and 16 slots, path ids up to 65535 (the slot word's sign
bit set from 32768), masks shorter and longer than the paths, as bool
and as int32. Each wrapper refusal raises before any dispatch, and the
sharded ELL query reduces all its tiers in one call. All comparisons are
exact (integer counts, tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pollen_tpu.kernels import ellscan as ref
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.kernels import ellscan as port
from pollen_tpu_torch.ops import depth as port_depth
from pollen_tpu_torch.parallel import launch
from pollen_tpu_torch.parallel import sharded as port_sh
from test_torch_depth import three_tier_graph
from test_torch_parallel import three_tier_bools, to_port

torch.set_num_threads(1)

RAGGED = 294_912 + 128
HIGH_IDS = (5, 32767, 32768, 40000, 65535)


def _flat(rng, k, n_pad, p, ids=()):
    """Seeded int32[k, n_pad] ``path << 16 | count`` slots over paths
    [0, p), 30% empty, with ``ids`` planted in the first columns and in
    the last (the ragged tile's) at counts up to 0xFFFF."""
    path = rng.integers(0, p, (k, n_pad))
    cnt = rng.integers(1, 0x10000, (k, n_pad))
    v = (path << 16) | cnt
    v[rng.random((k, n_pad)) < 0.3] = 0
    for j, pid in enumerate(ids):
        v[j % k, j] = (pid << 16) | (j + 1)
        v[(j + 1) % k, n_pad - 1 - j] = (pid << 16) | 0xFFFF
    return (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _mask(rng, length, dtype, ones=()):
    m = rng.random(length) < 0.5
    m[[i for i in ones if i < length]] = True
    return m if dtype == "bool" else m.astype(np.int32)


def _check_tiers(tiers, mask, p):
    """masked_ell_depth_tiers on the CPU (no launch) against the
    reference tier by tier: its Pallas kernel in interpret mode under the
    mask zero-extended to the ``p`` paths (the same mask: paths past its
    end read 0; the kernel itself reads a wrong word past a short mask's
    last word, test_reference_kernel_reads_past_a_short_mask) and its
    XLA form under the mask cut to 2^16 paths (slot ids are 16-bit; the
    XLA form refuses a longer mask)."""
    before = dict(port.launches)
    outs = port.masked_ell_depth_tiers([torch.from_numpy(e) for e in tiers],
                                       torch.from_numpy(mask))
    assert port.launches == before
    assert len(outs) == 2 * len(tiers)
    ext = np.zeros(max(len(mask), p), np.int32)
    ext[: len(mask)] = mask
    for i, e in enumerate(tiers):
        d_p, u_p = outs[2 * i], outs[2 * i + 1]
        assert d_p.dtype == u_p.dtype == torch.int32
        assert d_p.shape == u_p.shape == (e.shape[1],)
        for d_r, u_r in (
            ref.masked_ell_depth(jnp.asarray(e), jnp.asarray(ext), interpret=True),
            ref.masked_ell_depth_xla(jnp.asarray(e), jnp.asarray(mask[: 1 << 16])),
        ):
            assert np.array_equal(np.asarray(d_r), d_p.numpy())
            assert np.array_equal(np.asarray(u_r), u_p.numpy())
    return outs


# (k, columns) of each tier: every k of 1, 2, 3, 5, 9, 16 and every
# column count, in calls of 1, 2 and 3 tiers.
TIER_CASES = {
    "k1@128": [(1, 128)],
    "k16@1152": [(16, 1152)],
    "k2@294912+128": [(2, RAGGED)],
    "k3@1152,k5@128": [(3, 1152), (5, 128)],
    "k9@128,k1@294912+128": [(9, 128), (1, RAGGED)],
    "k1@128,k2@1152,k16@128": [(1, 128), (2, 1152), (16, 128)],
    "k5@1152,k3@128,k9@1152": [(5, 1152), (3, 128), (9, 1152)],
}
# 300 paths: masks of 200 (paths past the end read 0) and 400 entries.
MASKS = [(200, "bool"), (200, "int32"), (400, "bool"), (400, "int32")]


@pytest.mark.parametrize("length,dtype", MASKS,
                         ids=[f"{n}-{t}" for n, t in MASKS])
@pytest.mark.parametrize("case", list(TIER_CASES))
def test_flat_tiers_match_pallas_interpret(case, length, dtype):
    rng = np.random.default_rng(len(case) * 100 + length)
    tiers = [_flat(rng, k, n, 300) for k, n in TIER_CASES[case]]
    _check_tiers(tiers, _mask(rng, length, dtype), 300)


# 65,536 paths: an int32 mask of 40,001 (65535 reads 0) and a bool mask
# of 65,600 entries, every planted id selected where it fits.
HIGH_MASKS = [(40001, "int32"), (65600, "bool")]


@pytest.mark.parametrize("length,dtype", HIGH_MASKS,
                         ids=[f"{n}-{t}" for n, t in HIGH_MASKS])
@pytest.mark.parametrize("n_tiers", [1, 2, 3])
def test_flat_tiers_high_path_ids(n_tiers, length, dtype):
    """Path ids 5, 32767, 32768, 40000 and 65535 planted in every tier
    (one shape, so the reference compiles once a mask)."""
    rng = np.random.default_rng(n_tiers * 10 + length)
    tiers = [_flat(rng, 2, 1152, 65536, HIGH_IDS) for _ in range(n_tiers)]
    mask = _mask(rng, length, dtype, ones=HIGH_IDS)
    outs = _check_tiers(tiers, mask, 1 << 16)
    # And against a numpy sum: unsigned path ids, paths past the mask 0.
    m = np.zeros(1 << 16, np.int64)
    m[: min(length, 1 << 16)] = mask[: 1 << 16]
    for i, e in enumerate(tiers):
        v = e.view(np.uint32)
        bit = m[v >> 16]
        assert np.array_equal(outs[2 * i].numpy(), (bit * (v & 0xFFFF)).sum(0))
        assert np.array_equal(outs[2 * i + 1].numpy(), (bit * (v != 0)).sum(0))


def test_reference_kernel_reads_past_a_short_mask():
    """The reference's departure from its own contract, pinned so that a
    repaired reference shows up here: under a mask of 200 paths (7
    words) its Pallas kernel (interpret mode) selects word 8, path 264's,
    by the bits of its index in a tournament over the 7 words, lands on
    word 0 and counts the slot, where its XLA form and the port read 0
    past the mask's end."""
    e = np.zeros((1, 128), np.int32)
    e[0, 0] = (264 << 16) | 7
    e[0, 1] = (100 << 16) | 3
    mask = np.ones(200, np.int32)
    d_k, _ = ref.masked_ell_depth(jnp.asarray(e), jnp.asarray(mask), interpret=True)
    d_x, _ = ref.masked_ell_depth_xla(jnp.asarray(e), jnp.asarray(mask))
    d_p, _ = port.masked_ell_depth_tiers([torch.from_numpy(e)],
                                         torch.from_numpy(mask))
    assert np.asarray(d_k)[:2].tolist() == [7, 3]
    assert np.asarray(d_x)[:2].tolist() == d_p[:2].tolist() == [0, 3]


def _ok(n_pad=256):
    return torch.zeros((2, n_pad), dtype=torch.int32)


REJECTED = {
    "no tiers": ([], ValueError, "1-3 flat tiers"),
    "four tiers": ([_ok()] * 4, ValueError, "1-3 flat tiers"),
    "int64 slots": ([_ok(), _ok().long()], TypeError, "2-D int32"),
    "1-D slots": ([torch.zeros(256, dtype=torch.int32)], TypeError, "2-D int32"),
    "non-contiguous slots": (
        [_ok(), torch.zeros((256, 2), dtype=torch.int32).t()], ValueError,
        "contiguous"),
    "200 columns": ([_ok(), _ok(200)], ValueError, "multiple of 128"),
    "two devices": ([_ok(), _ok().to("meta")], ValueError, "one device"),
    "no kernel for meta": ([_ok().to("meta")], ValueError, "no kernel"),
}


@pytest.mark.parametrize("case", list(REJECTED))
def test_flat_tiers_refusals_raise_before_dispatch(case, monkeypatch):
    tiers, exc, match = REJECTED[case]

    def dispatched(*args):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(port, "masked_ell_depth_plain", dispatched)
    mask = torch.ones(8, dtype=torch.int32)
    if tiers and tiers[0].device.type == "meta":
        mask = mask.to("meta")
    before = dict(port.launches)
    with pytest.raises(exc, match=match):
        port.masked_ell_depth_tiers(tiers, mask)
    assert port.launches == before


def test_one_tier_form_is_the_tiers_entry():
    rng = np.random.default_rng(3)
    e = torch.from_numpy(_flat(rng, 3, 1152, 300))
    m = torch.from_numpy(_mask(rng, 300, "bool"))
    got = port.masked_ell_depth(e, m)
    want = port.masked_ell_depth_tiers([e], m)
    assert len(got) == 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_sharded_ell_query_is_one_tiers_call(monkeypatch):
    """A one-rank job on the CPU: the sharded ELL query over three flat
    tiers and heavy reduces every tier in one masked_ell_depth_tiers
    call, and its answer equals the single-device query's."""
    monkeypatch.setattr(port, "C_TIER_FIXED", 0.0)
    monkeypatch.setattr(port, "C_COL_B", 0.0)
    dg = build_graph(to_port(three_tier_graph()), "cpu")
    calls = []
    tiers_fn = port.masked_ell_depth_tiers

    def counted(tiers, mask):
        calls.append([tuple(t.shape) for t in tiers])
        return tiers_fn(tiers, mask)

    monkeypatch.setattr(port, "masked_ell_depth_tiers", counted)
    bools = three_tier_bools()
    with launch.world_of_one("cpu"):
        mesh = port_sh.make_mesh()
        se = port_sh.shard_ell_inputs(dg, mesh)
        has = dict(has_heavy=se.heavy is not None, has_mid=se.ell2 is not None,
                   has_mid2=se.ell3 is not None)
        assert all(has.values())
        fn = port_sh.sharded_ell_depth_fn(mesh, **has)
        parts = fn(*port_sh.ell_args(se, torch.from_numpy(bools).to(torch.int32)))
    assert calls == [[tuple(se.ell.shape), tuple(se.ell2.shape),
                      tuple(se.ell3.shape)]]
    d, u = port_sh.compose_ell_parts_natural(dg, parts, **has)
    d_1, u_1 = port_depth.seg_depth_with_uniq_masked(dg, torch.from_numpy(bools))
    assert np.array_equal(d, d_1.numpy()) and np.array_equal(u, u_1.numpy())
