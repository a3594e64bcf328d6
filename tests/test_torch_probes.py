"""The crossing-matrix probe ladder in the port (K10 raw and vd, K11,
K12: ``pollen_tpu_torch.kernels.crossprobe``) and its two probe
scripts, against the reference's TPU probes run in Pallas interpret
mode on the CPU (``probes/crossmat_floor.py``,
``probes/crossmat_variants.py``). All comparisons are exact (integer
counts, tolerance 0: the reference's bf16 dots accumulate in float32,
exact below 2^24 per column, and these matrices stay far below).
"""

import dataclasses
import importlib.util
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from conftest import FIXTURE_GRAPHS, GRAPH_DIR, REPO
from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import parse_gfa_file
from pollen_tpu.kernels import crossmat as ref_cm
from pollen_tpu_torch.device import from_host_arrays
from pollen_tpu_torch.kernels import crossprobe as port
from pollen_tpu_torch.probes import crossmat_floor, crossmat_variants

torch.set_num_threads(1)

P, N = 128, 16384  # the reference's tile there: pick_seg_block -> 8192
COMPLEX_W = 128  # columns of a "complex" tile of _matrix


def _load_probe(name):
    """A reference probe script, loaded by file path (it imports
    ``bench`` from the repository root)."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location(
        f"reference_probe_{name}", REPO / "probes" / f"{name}.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_floor():
    return _load_probe("crossmat_floor")


@pytest.fixture(scope="module")
def ref_variants():
    return _load_probe("crossmat_variants")


def _matrix(seed, complex_tiles=()):
    """uint8 (P/2, N) nibbles: counts 0/1 everywhere, counts up to 15
    in the listed 128-column tiles."""
    rng = np.random.default_rng(seed)
    lo = rng.random((P // 2, N)) < 0.3
    hi = rng.random((P // 2, N)) < 0.3
    a = (lo | (hi.astype(np.uint8) << 4)).astype(np.uint8)
    for t in complex_tiles:
        cols = slice(t * COMPLEX_W, (t + 1) * COMPLEX_W)
        a[:, cols] = rng.integers(0, 256, (P // 2, COMPLEX_W))
    return a


def _mask(seed, n=P):
    return np.random.default_rng(seed).integers(0, 2, n).astype(np.int32)


def _equal(ref_out, port_out):
    assert len(ref_out) == len(port_out) == 2
    for a, b in zip(ref_out, port_out):
        assert b.dtype == torch.int32 and b.shape == (N,)
        assert np.array_equal(np.asarray(a), b.numpy())


def _interpret(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return fn(*(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["raw", "vd"])
def test_floor_kernels_match_reference(ref_floor, mode, seed):
    """K10: the port's raw and vd wrappers (CPU path: their plain
    versions) against _make(_kernel_raw) and _make(_kernel_vd)."""
    a = _matrix(seed, complex_tiles=range(0, N // COMPLEX_W, 3))
    m = _mask(seed)
    kernel = {"raw": ref_floor._kernel_raw, "vd": ref_floor._kernel_vd}[mode]
    want = _interpret(ref_floor._make(kernel), a, m)
    before = dict(port.launches)
    wrapper = {"raw": port.cross_probe_raw, "vd": port.cross_probe_vd}[mode]
    got = wrapper(torch.from_numpy(a), torch.from_numpy(m))
    assert port.launches == before  # the CPU path launches no kernel
    _equal(want, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_v1_matches_reference(ref_variants, seed):
    """K11 against cross_depth_v1 and the dense query's XLA form."""
    a = _matrix(seed + 5, complex_tiles=(1, 7, 100))
    m = _mask(seed + 5)
    got = port.cross_probe_v1(torch.from_numpy(a), torch.from_numpy(m))
    _equal(_interpret(ref_variants.cross_depth_v1, a, m), got)
    _equal(ref_cm.masked_cross_depth_xla(jnp.asarray(a), jnp.asarray(m),
                                         nibble=True), got)


@pytest.mark.parametrize("flags", ["ones", "zeros", "tile_flags"])
def test_v2_matches_reference(ref_variants, flags):
    """K12 against cross_depth_v2. The reference's flags are per 8192
    columns and the port's per 512 (a warp's span of the dense query's
    tile): all ones and correct flags give v1's answer in both, all
    zeros give depth as uniq."""
    a = _matrix(9, complex_tiles=(3, 64, 65))
    m = _mask(9)
    width = ref_cm.pick_seg_block(P, N)
    ref_flags = {
        "ones": np.ones(N // width, np.int32),
        "zeros": np.zeros(N // width, np.int32),
        "tile_flags": ref_variants.tile_flags(
            types.SimpleNamespace(cross_matrix=jnp.asarray(a)), width),
    }[flags]
    port_flags = {
        "ones": torch.ones(N // port.TILE, dtype=torch.int32),
        "zeros": torch.zeros(N // port.TILE, dtype=torch.int32),
        "tile_flags": port.tile_flags(torch.from_numpy(a), port.TILE),
    }[flags]
    want = _interpret(ref_variants.cross_depth_v2, a, m, ref_flags)
    got = port.cross_probe_v2(torch.from_numpy(a), torch.from_numpy(m), port_flags)
    _equal(want, got)
    if flags == "zeros":
        assert torch.equal(got[0], got[1])
    else:
        _equal(_interpret(ref_variants.cross_depth_v1, a, m), got)


def test_v2_plain_matches_reference_on_any_flags(ref_variants):
    """The plain v2 at the reference's own tile width, on flags that
    are wrong for some tiles: the same answer tile by tile."""
    a = _matrix(12, complex_tiles=range(0, N // COMPLEX_W, 5))
    m = _mask(12)
    width = ref_cm.pick_seg_block(P, N)
    flags = np.array([1, 0], np.int32)[: N // width]
    want = _interpret(ref_variants.cross_depth_v2, a, m, flags)
    got = port.cross_probe_plain(torch.from_numpy(a), torch.from_numpy(m), "v2",
                                 torch.from_numpy(flags), width=width)
    _equal(want, got)


@pytest.mark.parametrize("complex_tiles", [(), (0,), (5, 6, 127)])
def test_tile_flags_match_reference(ref_variants, complex_tiles):
    a = _matrix(3, complex_tiles=complex_tiles)
    width = ref_cm.pick_seg_block(P, N)
    for w in (width, port.TILE):
        want = ref_variants.tile_flags(
            types.SimpleNamespace(cross_matrix=jnp.asarray(a)), w)
        got = port.tile_flags(torch.from_numpy(a), w)
        assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())
    got = port.tile_flags(torch.from_numpy(a), port.TILE).numpy()
    want = sorted({t * COMPLEX_W // port.TILE for t in complex_tiles})
    assert np.array_equal(np.flatnonzero(got), want)


@pytest.mark.parametrize("flags", ["tile_flags", "alternate"])
@pytest.mark.parametrize("n", [640, 1152])
def test_ragged_last_tile_matches_reference(ref_variants, n, flags):
    """Columns a multiple of 128 and not of the port's 512-column tile:
    its last tile is narrower. tile_flags against the reference's on the
    matrix zero-padded to whole tiles (padding holds no count); v2
    against cross_depth_v2 at the reference's own tile (128 here), each
    of its flags the port's flag of the 512 columns around it."""
    rng = np.random.default_rng(n)
    a = ((rng.random((P // 2, n)) < 0.3)
         | ((rng.random((P // 2, n)) < 0.3).astype(np.uint8) << 4))
    a = a.astype(np.uint8)
    a[:, -128:] = rng.integers(0, 256, (P // 2, 128))  # the ragged tile
    a[:, 128:256] = rng.integers(0, 256, (P // 2, 128))
    tiles = port.n_tiles(n)
    assert tiles * port.TILE > n
    padded = np.zeros((P // 2, tiles * port.TILE), np.uint8)
    padded[:, :n] = a
    want = ref_variants.tile_flags(
        types.SimpleNamespace(cross_matrix=jnp.asarray(padded)), port.TILE)
    got = port.tile_flags(torch.from_numpy(a))
    assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())
    assert got[-1] == 1
    f = got if flags == "tile_flags" else torch.arange(tiles, dtype=torch.int32) % 2
    width = ref_cm.pick_seg_block(P, n)
    assert port.TILE % width == 0
    ref_flags = np.repeat(f.numpy(), port.TILE // width)[: n // width]
    m = _mask(n)
    want = _interpret(ref_variants.cross_depth_v2, a, m, ref_flags)
    got = port.cross_probe_v2(torch.from_numpy(a), torch.from_numpy(m), f)
    assert len(got) == 2
    for x, y in zip(want, got):
        assert y.dtype == torch.int32 and y.shape == (n,)
        assert np.array_equal(np.asarray(x), y.numpy())
    plain = port.cross_probe_plain(torch.from_numpy(a), torch.from_numpy(m),
                                   "v2", f)
    assert all(torch.equal(x, y) for x, y in zip(plain, got))


@pytest.mark.parametrize("name", FIXTURE_GRAPHS)
def test_ladder_on_reference_matrices(name):
    """The reference's host-built crossing matrix, carried across with
    from_host_arrays: every rung against the dense query's XLA form,
    masks shorter than P_pad."""
    dg = build_device_graph(parse_gfa_file(str(GRAPH_DIR / name)), device="host",
                            cross_matrix="always")
    assert dg.cross_nibble
    fields = {f.name: getattr(dg, f.name) for f in dataclasses.fields(dg)}
    cross = from_host_arrays(fields, "cpu").cross_matrix
    m = _mask(len(name), dg.num_paths)
    mp = np.zeros(2 * cross.shape[0], np.int32)
    mp[: dg.num_paths] = m
    d, u = (np.asarray(x) for x in ref_cm.masked_cross_depth_xla(
        jnp.asarray(dg.cross_matrix), jnp.asarray(mp), nibble=True))
    mt = torch.from_numpy(m)
    raw = (np.asarray(dg.cross_matrix).astype(np.int64) * mp[0::2, None]).sum(0)
    assert np.array_equal(port.cross_probe_raw(cross, mt)[0].numpy(), raw)
    assert np.array_equal(port.cross_probe_vd(cross, mt)[1].numpy(), d)
    d1, u1 = port.cross_probe_v1(cross, mt)
    assert np.array_equal(d1.numpy(), d) and np.array_equal(u1.numpy(), u)
    flags = port.tile_flags(cross, port.TILE)
    d2, u2 = port.cross_probe_v2(cross, mt, flags)
    assert np.array_equal(d2.numpy(), d) and np.array_equal(u2.numpy(), u)


def test_probe_wrappers_check_inputs():
    a = torch.zeros((64, 256), dtype=torch.uint8)
    m = torch.ones(128, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"one per {port.TILE}"):
        port.cross_probe_v2(a, m, torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match=f"one per {port.TILE}"):
        port.cross_probe_v2(a, m, None)
    with pytest.raises(TypeError):
        port.cross_probe_v1(a.to(torch.int8), m)
    with pytest.raises(ValueError, match="no kernel"):
        port.cross_probe_raw(a.to("meta"), m.to("meta"))
    with pytest.raises(ValueError, match="tiles of"):
        port.tile_flags(a, 100)
    with pytest.raises(ValueError, match="unknown probe mode"):
        port.cross_probe_plain(a, m, "v3")


@pytest.mark.parametrize("script", ["floor", "variants"])
def test_probe_scripts_run_on_cpu(script, monkeypatch, capsys):
    """run() and main() with --device cpu at a small size: every check
    passes, one line per variant in the reference's form."""
    monkeypatch.setenv("POLLEN_BENCH_STEPS", "30000")
    monkeypatch.setenv("POLLEN_BENCH_SEGS", "4096")
    monkeypatch.setenv("POLLEN_BENCH_PATHS", "40")
    mod = {"floor": crossmat_floor, "variants": crossmat_variants}[script]
    assert mod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in mod.VARIANTS:
        line = next(ln for ln in out.splitlines() if ln.startswith(f"{name}: "))
        assert "us/query" in line and "G steps/s" in line
        assert "[host clock, cpu]" in line
        assert ("exact=True" in line if script == "floor"
                else "depth_ok=True" in line)
    if script == "variants":
        assert f"complex tiles (width {port.TILE})" in out
    with pytest.raises(SystemExit):
        mod.main(["--device", "cpu", "nope"])
