"""Port crossing-matrix module (pollen_tpu_torch.kernels.crossmat)
against the JAX reference: layout helpers, the plain GEMV, and the
kernel wrapper's CPU path against the Pallas kernel in interpret mode.
All comparisons are exact (integer counts, tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pollen_tpu.kernels import crossmat as ref
from pollen_tpu_torch.kernels import crossmat as port

torch.set_num_threads(1)


def _matrix(rng, p_pad, n_pad, nibble, density=0.4):
    if nibble:
        a = rng.integers(0, 256, (p_pad // 2, n_pad)).astype(np.uint8)
        a[rng.random(a.shape) > density] = 0
        return a
    a = rng.integers(0, 128, (p_pad, n_pad)).astype(np.int8)
    a[rng.random(a.shape) > density] = 0
    return a


def test_constants_match_reference():
    for name in ("LANES", "SEG_BLOCK", "CLIP", "CLIP_NIBBLE", "RES_SENTINEL"):
        assert getattr(port, name) == getattr(ref, name), name


def test_fold_and_unpack_match_reference():
    rng = np.random.default_rng(0)
    a = _matrix(rng, 256, 384, nibble=True)
    assert np.array_equal(
        np.asarray(ref.unpack_cross(jnp.asarray(a))),
        port.unpack_cross(torch.from_numpy(a)).numpy(),
    )
    v = rng.integers(0, 2, 256).astype(np.int32)
    assert np.array_equal(
        np.asarray(ref.fold_mask(jnp.asarray(v))),
        port.fold_mask(torch.from_numpy(v)).numpy(),
    )


@pytest.mark.parametrize("nibble", [True, False])
@pytest.mark.parametrize("p_pad", [128, 384])
def test_masked_cross_depth_plain_matches_xla(nibble, p_pad):
    rng = np.random.default_rng(p_pad + nibble)
    a = _matrix(rng, p_pad, 1024, nibble)
    mask = rng.integers(0, 2, p_pad).astype(np.int32)
    d_r, u_r = ref.masked_cross_depth_xla(
        jnp.asarray(a), jnp.asarray(mask), nibble=nibble
    )
    d_p, u_p = port.masked_cross_depth_plain(
        torch.from_numpy(a), torch.from_numpy(mask), nibble=nibble
    )
    assert d_p.dtype == torch.int32 and u_p.dtype == torch.int32
    assert np.array_equal(np.asarray(d_r), d_p.numpy())
    assert np.array_equal(np.asarray(u_r), u_p.numpy())


@pytest.mark.parametrize("nibble", [True, False])
def test_cross_wrapper_matches_pallas_interpret(nibble):
    rng = np.random.default_rng(5 + nibble)
    p_pad = 128
    a = _matrix(rng, p_pad, 1024, nibble)
    mask = rng.integers(0, 2, p_pad).astype(np.int32)
    d_r, u_r = ref.masked_cross_depth(
        jnp.asarray(a), jnp.asarray(mask), nibble=nibble, interpret=True
    )
    before = dict(port.launches)
    d_p, u_p = port.masked_cross_depth(
        torch.from_numpy(a), torch.from_numpy(mask), nibble=nibble
    )
    assert port.launches == before  # the CPU path launches no kernel
    assert np.array_equal(np.asarray(d_r), d_p.numpy())
    assert np.array_equal(np.asarray(u_r), u_p.numpy())
    # Depth-only variant, and a mask shorter than P_pad (num_paths).
    d_only = port.masked_cross_depth(
        torch.from_numpy(a), torch.from_numpy(mask[:100]), nibble=nibble,
        uniq=False,
    )
    d_short = ref.masked_cross_depth_xla(
        jnp.asarray(a),
        jnp.asarray(np.concatenate([mask[:100], np.zeros(28, np.int32)])),
        nibble=nibble,
    )[0]
    assert isinstance(d_only, torch.Tensor)
    assert np.array_equal(np.asarray(d_short), d_only.numpy())


@pytest.mark.parametrize("nibble", [True, False])
@pytest.mark.parametrize("p_pad", [128, 384])
def test_batched_cross_depth_plain_matches_xla(nibble, p_pad):
    rng = np.random.default_rng(p_pad + nibble + 10)
    a = _matrix(rng, p_pad, 512, nibble)
    masks = rng.integers(0, 2, (7, p_pad)).astype(np.int32)
    d_r, u_r = ref.batched_cross_depth(
        jnp.asarray(a), jnp.asarray(masks), nibble=nibble
    )
    d_p, u_p = port.batched_cross_depth_plain(
        torch.from_numpy(a), torch.from_numpy(masks), nibble=nibble
    )
    assert d_p.dtype == torch.int32 and u_p.dtype == torch.int32
    assert np.array_equal(np.asarray(d_r), d_p.numpy())
    assert np.array_equal(np.asarray(u_r), u_p.numpy())


@pytest.mark.parametrize("nibble", [True, False])
@pytest.mark.parametrize("q", [1, 5, 16])
def test_batched_cross_wrapper_matches_pallas_interpret(nibble, q):
    """Both layouts, Q = 1, a ragged Q (the reference pads to 8) and
    Q = 16; masks shorter than P_pad are zero-padded."""
    rng = np.random.default_rng(20 + q + nibble)
    p_pad = 128
    a = _matrix(rng, p_pad, 1024, nibble)
    masks = rng.integers(0, 2, (q, p_pad)).astype(np.int32)
    masks[:, 100:] = 0
    d_r, u_r = ref.batched_cross_depth_pallas(
        jnp.asarray(a), jnp.asarray(masks), nibble=nibble, interpret=True
    )
    before = dict(port.launches)
    d_p, u_p = port.batched_cross_depth(
        torch.from_numpy(a), torch.from_numpy(masks[:, :100]), nibble=nibble
    )
    assert port.launches == before  # the CPU path launches no kernel
    assert d_p.shape == (q, 1024) and d_p.dtype == torch.int32
    assert np.array_equal(np.asarray(d_r), d_p.numpy())
    assert np.array_equal(np.asarray(u_r), u_p.numpy())
    for i in range(q):
        d1, u1 = port.masked_cross_depth(
            torch.from_numpy(a), torch.from_numpy(masks[i]), nibble=nibble
        )
        assert torch.equal(d_p[i], d1) and torch.equal(u_p[i], u1)


def _batched_reference(a, masks, nibble):
    """The reference's Pallas kernel in interpret mode, on the matrix and
    masks zero-padded to a multiple of 8 paths (its tile rule): extra
    zero paths change no sum."""
    rows, n_pad = a.shape
    p = rows * 2 if nibble else rows
    p8 = -(-p // 8) * 8
    a8 = np.zeros((p8 // 2 if nibble else p8, n_pad), a.dtype)
    a8[:rows] = a
    m8 = np.zeros((masks.shape[0], p8), np.int32)
    m8[:, : masks.shape[1]] = masks
    return ref.batched_cross_depth_pallas(
        jnp.asarray(a8), jnp.asarray(m8), nibble=nibble, interpret=True
    )


# The tensor-core kernel's edges: P = 2 (one byte row), 33 (K padded
# past one 32-path step), 300 (several steps, ragged); Q = 1, 16 (one
# mma row tile), 17 (one over), 40 (two 32-query chunks).
@pytest.mark.parametrize("nibble", [True, False])
@pytest.mark.parametrize("p", [2, 33, 300])
@pytest.mark.parametrize("q", [1, 16, 17, 40])
def test_batched_cross_edge_shapes_match_pallas_interpret(nibble, p, q):
    rng = np.random.default_rng(100 * p + q + nibble)
    rows = -(-p // 2) if nibble else p
    a = _matrix(rng, 2 * rows if nibble else rows, 256, nibble)
    masks = (rng.random((q, p)) < rng.random((q, 1))).astype(np.int32)
    d_r, u_r = _batched_reference(a, masks, nibble)
    d_p, u_p = port.batched_cross_depth(
        torch.from_numpy(a), torch.from_numpy(masks), nibble=nibble
    )
    assert d_p.shape == (q, 256) and d_p.dtype == torch.int32
    assert np.array_equal(np.asarray(d_r), d_p.numpy())
    assert np.array_equal(np.asarray(u_r), u_p.numpy())


@pytest.mark.parametrize("nibble", [True, False])
@pytest.mark.parametrize("q", [1, 17])
def test_batched_cross_at_the_clip(nibble, q):
    """Every cell at its clip (15 nibble, 127 int8) under all-ones
    masks: depth = clip * P and uniq = P exactly, as in the reference."""
    p = 300
    rows = p // 2 if nibble else p
    clip = port.CLIP_NIBBLE if nibble else port.CLIP
    a = np.full((rows, 256), 0xFF if nibble else clip,
                np.uint8 if nibble else np.int8)
    masks = np.ones((q, p), np.int32)
    d_r, u_r = _batched_reference(a, masks, nibble)
    d_p, u_p = port.batched_cross_depth(
        torch.from_numpy(a), torch.from_numpy(masks), nibble=nibble
    )
    assert bool((d_p == clip * p).all()) and bool((u_p == p).all())
    assert np.array_equal(np.asarray(d_r), d_p.numpy())
    assert np.array_equal(np.asarray(u_r), u_p.numpy())


def test_batched_cross_wrapper_checks_inputs():
    a = torch.zeros((64, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="Q >= 1"):
        port.batched_cross_depth(a, torch.ones(128), nibble=True)
    with pytest.raises(TypeError):
        port.batched_cross_depth(a, torch.ones((2, 128)), nibble=False)
    with pytest.raises(ValueError, match="no kernel"):
        port.batched_cross_depth(
            a.to("meta"), torch.ones((2, 128), device="meta"), nibble=True
        )


def test_cross_wrapper_checks_inputs():
    mask = torch.ones(128, dtype=torch.int32)
    a = torch.zeros((64, 256), dtype=torch.uint8)
    with pytest.raises(TypeError):
        port.masked_cross_depth(a, mask, nibble=False)  # uint8 is nibble
    with pytest.raises(TypeError):
        port.masked_cross_depth(a.to(torch.int8), mask, nibble=True)
    with pytest.raises(ValueError):
        port.masked_cross_depth(a[:, :200].contiguous(), mask, nibble=True)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(64 * 256 + 1, dtype=torch.uint8)
        port.masked_cross_depth(flat[1:].view(64, 256), mask, nibble=True)
    with pytest.raises(ValueError, match="no kernel"):
        port.masked_cross_depth(a.to("meta"), mask.to("meta"), nibble=True)


def _single_reference(a, mask, nibble, uniq=True):
    """The reference's Pallas kernel (K2) in interpret mode, on the
    matrix and mask zero-padded to a multiple of 8 paths (its tile
    rule) and the mask cut or padded to the matrix's paths: extra zero
    paths change no sum."""
    rows, n_pad = a.shape
    p = rows * 2 if nibble else rows
    p8 = -(-p // 8) * 8
    a8 = np.zeros((p8 // 2 if nibble else p8, n_pad), a.dtype)
    a8[:rows] = a
    m8 = np.zeros(p8, np.int32)
    m8[: min(p, mask.shape[0])] = mask[:p]
    return ref.masked_cross_depth(
        jnp.asarray(a8), jnp.asarray(m8), nibble=nibble, interpret=True,
        uniq=uniq,
    )


# The one-launch kernel's edges: byte rows that are not a multiple of
# the 8 rows a thread has in flight (1, 13, 33), one 128-column tile,
# ragged tiles (384, 1152), masks shorter and longer than the paths.
@pytest.mark.parametrize("nibble", [True, False])
@pytest.mark.parametrize("rows,n_pad", [(1, 128), (13, 128), (13, 1152), (33, 384)])
def test_cross_odd_shapes_match_pallas_interpret(nibble, rows, n_pad):
    rng = np.random.default_rng(7 * rows + n_pad + nibble)
    p = 2 * rows if nibble else rows
    a = _matrix(rng, p + (p % 2), n_pad, nibble)[:rows]
    for plen in (p, max(p - 3, 1), p + 40):
        mask = (rng.random(plen) < rng.random()).astype(np.int32)
        d_r, u_r = _single_reference(a, mask, nibble)
        d_p, u_p = port.masked_cross_depth(
            torch.from_numpy(a), torch.from_numpy(mask), nibble=nibble
        )
        assert np.array_equal(np.asarray(d_r), d_p.numpy())
        assert np.array_equal(np.asarray(u_r), u_p.numpy())
        d_only = port.masked_cross_depth(
            torch.from_numpy(a), torch.from_numpy(mask), nibble=nibble,
            uniq=False,
        )
        d_ref_only = _single_reference(a, mask, nibble, uniq=False)
        assert np.array_equal(np.asarray(d_ref_only), d_only.numpy())


@pytest.mark.parametrize("nibble", [True, False])
def test_cross_at_the_clip(nibble):
    """Every cell at its clip (15 nibble, 127 int8) under the all-ones
    mask: depth = clip * P and uniq = P exactly, as in the reference,
    with and without uniq."""
    rows = 13 if nibble else 26
    p = 2 * rows if nibble else rows
    clip = port.CLIP_NIBBLE if nibble else port.CLIP
    a = np.full((rows, 256), 0xFF if nibble else clip,
                np.uint8 if nibble else np.int8)
    mask = np.ones(p, np.int32)
    d_r, u_r = _single_reference(a, mask, nibble)
    d_p, u_p = port.masked_cross_depth(
        torch.from_numpy(a), torch.from_numpy(mask), nibble=nibble
    )
    assert bool((d_p == clip * p).all()) and bool((u_p == p).all())
    assert np.array_equal(np.asarray(d_r), d_p.numpy())
    assert np.array_equal(np.asarray(u_r), u_p.numpy())
    d_only = port.masked_cross_depth(
        torch.from_numpy(a), torch.from_numpy(mask), nibble=nibble, uniq=False
    )
    assert np.array_equal(np.asarray(d_r), d_only.numpy())
