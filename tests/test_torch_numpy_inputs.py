"""The port's other public device ops take what the reference's take:
host (numpy) arrays as well as tensors.

``positions_in_path``, ``chunk_reads``, ``node_depth_accel`` and
``node_depth_accel_simple`` are jitted in the reference, so numpy goes
in as it is. The same inputs go through the reference (JAX, CPU) and
through the port on the CPU, given as numpy arrays, as tensors, and as
numpy beside a tensor that sets the device; every answer must equal the
reference's exactly (tolerance 0). Inputs: every offset of each path of
``tests/graphs/rand1.gfa`` and two past its end; hand-made reads whose
steps are skipped (NONE), fully covered (ALL) and partially covered
(PARTIAL) in both orientations; seeded PE memories with empty slots.
A tensor on another device than the op's is refused, never copied.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import GRAPH_DIR
from pollen_tpu.accel import kernel as ref_kernel
from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import parse_gfa_file as ref_parse_gfa_file
from pollen_tpu.ops import gaf as ref_gaf
from pollen_tpu.ops import position as ref_position
from pollen_tpu_torch.accel import kernel as port_kernel
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.flatgfa import parse_gfa_file
from pollen_tpu_torch.ops import gaf as port_gaf
from pollen_tpu_torch.ops import position as port_position

torch.set_num_threads(1)

RAND1 = GRAPH_DIR / "rand1.gfa"
RAND1_PATHS = 6


def assert_same(got, want, dtypes):
    """The port's outputs: tensors of the documented dtypes, each equal
    to the reference's output (compared by value: the reference's
    integer widths follow JAX's x64 setting)."""
    assert len(got) == len(want) == len(dtypes)
    for g, w, dt in zip(got, want, dtypes):
        assert isinstance(g, torch.Tensor) and g.dtype == dt
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.array_equal(g.numpy().astype(np.int64), w.astype(np.int64))


# positions_in_path -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def rand1():
    g_ref = ref_parse_gfa_file(str(RAND1))
    g = parse_gfa_file(str(RAND1))
    return (g, build_device_graph(g_ref, cross_matrix="never"),
            build_graph(g, "cpu", cross_matrix="never"))


def path_offsets(g, p):
    """(every offset of path p, two past it, and far past: int64; the
    path's length in bp)."""
    lo, hi = g.path_steps[p]
    total = int(g.seg_len[(g.steps[lo:hi] >> 1).astype(np.int64)].sum())
    offsets = np.concatenate([np.arange(total + 3), [total + 1000, 2**40]])
    return offsets.astype(np.int64), total


OFFSET_FORMS = {
    "numpy": lambda x: x,
    "tensor": torch.from_numpy,
}


@pytest.mark.parametrize("form", OFFSET_FORMS)
@pytest.mark.parametrize("path", range(RAND1_PATHS))
def test_positions_in_path_takes_numpy(path, form):
    g, ref_dg, dg = rand1()
    assert g.num_paths == RAND1_PATHS
    offsets, total = path_offsets(g, path)
    want = ref_position.positions_in_path(
        ref_dg, jnp.asarray(path, dtype=jnp.int32), offsets
    )
    got = port_position.positions_in_path(dg, path, OFFSET_FORMS[form](offsets))
    assert_same(got, want, (torch.int64, torch.int64, torch.bool))
    assert got[2].numpy().sum() == total


# chunk_reads -------------------------------------------------------------

# Segments of 4, 3, 5 and 2 bp.
SEG_LEN = np.array([4, 3, 5, 2], np.int32)
# Reads as (steps as (segment, reverse) pairs, start, end).
READ_SETS = {
    "forward": [
        ([(0, 0), (1, 0), (2, 0), (3, 0)], 4, 7),
        ([(0, 0), (1, 0)], 6, 7),
        ([(1, 0)], 0, 3),
        ([(2, 0), (3, 0), (0, 0)], 1, 10),
    ],
    "reverse": [
        ([(2, 1), (1, 1), (0, 1)], 2, 11),
        ([(0, 1), (1, 1), (2, 1), (3, 1)], 1, 13),
        ([(3, 1), (2, 1)], 0, 7),
        ([(1, 1), (0, 1)], 5, 6),
    ],
    "mixed": [
        ([(3, 0), (0, 1), (2, 0)], 0, 11),
        ([(3, 1), (0, 0), (2, 1)], 5, 6),
        ([(0, 0), (0, 1), (1, 0), (1, 1)], 3, 12),
        ([(2, 1), (2, 0)], 0, 10),
        ([(0, 0), (1, 1)], 5, 6),
    ],
}


def read_arrays(reads):
    """(steps uint32[T], read_id int32[T], start int64[R], end int64[R])."""
    steps = np.array([s << 1 | r for walk, _, _ in reads for s, r in walk],
                     np.uint32)
    read_id = np.repeat(np.arange(len(reads), dtype=np.int32),
                        [len(walk) for walk, _, _ in reads])
    start = np.array([a for _, a, _ in reads], np.int64)
    end = np.array([b for _, _, b in reads], np.int64)
    return steps, read_id, start, end


def tensors(seg_len, steps, read_id, start, end):
    """The tensor form of the inputs: handles as their int32 bits."""
    return (torch.from_numpy(seg_len), torch.from_numpy(steps.view(np.int32)),
            torch.from_numpy(read_id), torch.from_numpy(start),
            torch.from_numpy(end))


CHUNK_FORMS = {
    "numpy": lambda *a: a,
    "tensor": tensors,
    "numpy beside a tensor seg_len": lambda seg_len, *a: (
        torch.from_numpy(seg_len), *a),
}


@pytest.mark.parametrize("form", CHUNK_FORMS)
@pytest.mark.parametrize("reads", READ_SETS)
def test_chunk_reads_takes_numpy(reads, form):
    args = (SEG_LEN, *read_arrays(READ_SETS[reads]))
    want = ref_gaf.chunk_reads(*(jnp.asarray(x) for x in args))
    kind = np.asarray(want[0])
    rev = (args[1] & 1).astype(bool)
    for k in (port_gaf.KIND_NONE, port_gaf.KIND_ALL, port_gaf.KIND_PARTIAL):
        if reads != "forward":
            assert (kind[rev] == k).any(), (reads, k)
        if reads != "reverse":
            assert (kind[~rev] == k).any(), (reads, k)
    got = port_gaf.chunk_reads(*CHUNK_FORMS[form](*args))
    assert_same(got, want, (torch.uint8, torch.int64, torch.int64))


# node_depth_accel, node_depth_accel_simple -------------------------------


def memories(seed, n=48, e=8, p=20):
    """Seeded PE memories (30% empty slots) and a consider bitvector."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, p + 1, (n, e)).astype(np.int32)
    ids[rng.random((n, e)) < 0.3] = 0
    consider = rng.integers(0, 2, p + 1).astype(np.int32)
    return ids, consider, p


ACCEL_FORMS = {
    "numpy": lambda ids, cons: (ids, cons),
    "tensor": lambda ids, cons: (torch.from_numpy(ids), torch.from_numpy(cons)),
    "numpy beside tensor path_ids": lambda ids, cons: (
        torch.from_numpy(ids), cons),
}
ACCELS = {
    "node_depth_accel": (port_kernel.node_depth_accel,
                         ref_kernel.node_depth_accel),
    "node_depth_accel_simple": (port_kernel.node_depth_accel_simple,
                                ref_kernel.node_depth_accel_simple),
}


@pytest.mark.parametrize("form", ACCEL_FORMS)
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("op", ACCELS)
def test_accelerator_takes_numpy(op, seed, form):
    ids, consider, max_p = memories(seed)
    assert (ids == 0).any()
    port_fn, ref_fn = ACCELS[op]
    want = ref_fn(ids, consider, max_p)
    got = port_fn(*ACCEL_FORMS[form](ids, consider), max_p)
    assert_same(got, want, (torch.int32, torch.int32))


# Mixed devices --------------------------------------------------------------

# A tensor argument on another device than the one the op runs on (the
# device of seg_len or path_ids, the CPU for a host array) is refused,
# never copied inside the op. The meta device stands for the other card.
def on_meta(x):
    return torch.as_tensor(x).to("meta")


MIXED = {
    "chunk_reads, steps beside numpy seg_len": lambda: port_gaf.chunk_reads(
        SEG_LEN, on_meta(read_arrays(READ_SETS["forward"])[0].view(np.int32)),
        *read_arrays(READ_SETS["forward"])[1:]),
    "chunk_reads, read_start beside a tensor seg_len": lambda: (
        port_gaf.chunk_reads(
            torch.from_numpy(SEG_LEN), *read_arrays(READ_SETS["mixed"])[:2],
            on_meta(read_arrays(READ_SETS["mixed"])[2]),
            read_arrays(READ_SETS["mixed"])[3])),
    **{
        f"{op}, consider beside {form} path_ids": (
            lambda fn=ACCELS[op][0], wrap=wrap: fn(
                wrap(memories(0)[0]), on_meta(memories(0)[1]), memories(0)[2]))
        for op in ACCELS
        for form, wrap in (("numpy", lambda x: x),
                           ("tensor", torch.from_numpy))
    },
}


@pytest.mark.parametrize("case", MIXED)
def test_op_refuses_a_tensor_on_another_device(case):
    with pytest.raises(ValueError, match="the op runs on cpu"):
        MIXED[case]()
