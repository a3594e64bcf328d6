"""The port's byte-range loader and rank-sharded ingest
(pollen_tpu_torch/parallel/loader.py, distributed.py) against the
reference's: the counterparts of tests/test_loader.py. Range-sharded
arenas equal direct parses field by field, split points come from seeks
(not whole reads), a world of one rank reduces to the single-process
load, and a real 2-rank gloo exchange (one spawned job for the module,
every fixture in it) assembles the reference's arena on each rank.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_rank_jobs
from conftest import FIXTURE_GRAPHS, GRAPH_DIR
from pollen_tpu.device import build_device_graph
from pollen_tpu.emit import emit_gfa as ref_emit_gfa
from pollen_tpu.flatgfa import parse_gfa_file as ref_parse_gfa_file
from pollen_tpu.ops.depth import seg_depth_with_uniq as ref_seg_depth_with_uniq
from pollen_tpu.parallel import loader as ref_loader
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.emit import emit_gfa
from pollen_tpu_torch.flatgfa import parse_gfa_file
from pollen_tpu_torch.ops.depth import seg_depth_with_uniq
from pollen_tpu_torch.parallel import distributed, launch
from pollen_tpu_torch.parallel.loader import (
    load_gfa_sharded,
    parse_range_file,
    split_ranges,
    split_ranges_file,
)
from pollen_tpu_torch.parallel.sharded import full_mask, make_mesh, sharded_seg_depth_fn

torch.set_num_threads(1)

JOB_DEADLINE = 180  # seconds; the job takes a few


def test_split_ranges_alignment(tmp_path):
    data = b"aaa\nbbbb\ncc\ndddddd\ne\n"
    ranges = split_ranges(len(data), 3, data)
    assert ranges == ref_loader.split_ranges(len(data), 3, data)
    assert ranges[0][0] == 0 and ranges[-1][1] == len(data)
    for lo, hi in ranges:
        assert lo == 0 or data[lo - 1 : lo] == b"\n"
    joined = b"".join(data[lo:hi] for lo, hi in ranges)
    assert joined == data
    # The file-based splitter (size-only seek + window reads) agrees.
    f = tmp_path / "x.txt"
    f.write_bytes(data)
    assert split_ranges_file(str(f), 3) == ranges == ref_loader.split_ranges_file(str(f), 3)


def assert_arenas_identical(a, b):
    for field in dataclasses.fields(a):
        np.testing.assert_array_equal(
            getattr(a, field.name), getattr(b, field.name), err_msg=field.name
        )


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_sharded_load_matches_direct(case, n):
    """Range-sharded assembly is byte-identical to a direct parse and to
    the reference's range-sharded assembly: every pool equal, the
    preserved-order emission equal, the same depth."""
    path = str(GRAPH_DIR / case)
    direct = parse_gfa_file(path)
    sharded = load_gfa_sharded(path, n)
    assert_arenas_identical(direct, sharded)
    assert_arenas_identical(ref_loader.load_gfa_sharded(path, n), sharded)
    assert emit_gfa(sharded, order="preserved") == emit_gfa(direct, order="preserved")
    assert emit_gfa(sharded, order="preserved") == ref_emit_gfa(
        ref_parse_gfa_file(path), order="preserved"
    )
    d1, u1 = seg_depth_with_uniq(build_graph(direct, "cpu"))
    d2, u2 = seg_depth_with_uniq(build_graph(sharded, "cpu"))
    assert torch.equal(d1, d2) and torch.equal(u1, u2)


def test_parse_range_reads_only_its_slice(tmp_path):
    """Phase-1 parse work is O(range), not O(file): parse_range_file
    sees only its own bytes (asserted via the parsed pool contents),
    and each range's pools are the reference's."""
    text = b"S\t1\tAA\nS\t2\tCC\nS\t3\tGG\nP\tp\t1+,3-\t*\n"
    f = tmp_path / "x.gfa"
    f.write_bytes(text)
    ranges = split_ranges_file(str(f), 3)
    assert sum(hi - lo for lo, hi in ranges) == len(text)
    d0 = parse_range_file(str(f), *ranges[0])
    # The first range holds only its own segment lines.
    assert d0.seg_name.shape[0] < 3
    total = 0
    for lo, hi in ranges:
        port = parse_range_file(str(f), lo, hi)
        assert_arenas_identical(port, ref_loader.parse_range_file(str(f), lo, hi))
        total += port.seg_name.shape[0]
    assert total == 3


def test_cross_range_references(tmp_path):
    """A path in range 0 referencing segments defined in range 2 still
    resolves (the two-pass defer across ranges)."""
    text = b"P\tp\t3+,1+\t*\n" + b"S\t1\tAA\n" + b"S\t2\tCC\nS\t3\tGG\n"
    f = tmp_path / "x.gfa"
    f.write_bytes(text)
    g = load_gfa_sharded(str(f), 3)
    assert g.num_paths == 1
    steps = g.path_step_slice(0)
    assert [int(g.seg_name[s >> 1]) for s in steps] == [3, 1]
    assert_arenas_identical(g, ref_loader.load_gfa_sharded(str(f), 3))


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_distributed_single_process(case):
    """The rank-sharded ingest in a world of one rank (this process, a
    gloo group of one): it reduces to the single-process load, and the
    sharded query on it equals the direct parse's depth."""
    path = str(GRAPH_DIR / case)
    with launch.world_of_one("cpu"):
        mesh = make_mesh()
        assert tuple(mesh.shape) == (1, 1)
        arena = distributed.ingest_arena(path)
        sg = distributed.ingest(path, mesh, device="cpu")
        depth_m, uniq_m = sharded_seg_depth_fn(mesh)(sg, full_mask(sg.num_paths))
    assert_arenas_identical(arena, parse_gfa_file(path))
    d1, u1 = ref_seg_depth_with_uniq(build_device_graph(ref_parse_gfa_file(path)))
    # The assembly keeps file-order ids, so results align with the
    # direct parse.
    np.testing.assert_array_equal(depth_m.numpy(), np.asarray(d1))
    np.testing.assert_array_equal(uniq_m.numpy(), np.asarray(u1))


def test_exchange_blobs_world_of_one():
    """The padded exchange returns the blob itself in a world of one,
    empty blobs included."""
    with launch.world_of_one("cpu"):
        assert distributed.exchange_blobs(b"abc\x00", 1) == [b"abc\x00"]
        assert distributed.exchange_blobs(b"", 1) == [b""]


@pytest.fixture(scope="module")
def exchange():
    """The one spawned job of this module: 2 gloo ranks, each parsing
    its own byte range of every fixture and exchanging pools."""
    paths = [str(GRAPH_DIR / case) for case in FIXTURE_GRAPHS]
    return launch.run(
        torch_rank_jobs.exchange_ingest, 2, paths, device="cpu",
        deadline=JOB_DEADLINE, threads=1,
    )


def test_exchange_ranks_load_no_jax_nor_reference(exchange):
    assert [r["foreign_modules"] for r in exchange] == [[], []]


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_distributed_two_process_exchange(case, exchange):
    """REAL 2-rank job (gloo, CPU): each rank parses only its own byte
    range, the padded uint8 all-gathers share the name table and the
    resolved pools, and both assemble the reference's arena field by
    field; the sharded query on the ingested graph equals the direct
    parse's depth."""
    path = str(GRAPH_DIR / case)
    direct = ref_parse_gfa_file(path)
    d1, u1 = ref_seg_depth_with_uniq(build_device_graph(direct))
    for rank in exchange:
        got = rank[path]
        for field in dataclasses.fields(direct):
            np.testing.assert_array_equal(
                got["arena"][field.name], getattr(direct, field.name), err_msg=field.name
            )
        np.testing.assert_array_equal(got["depth"], np.asarray(d1))
        np.testing.assert_array_equal(got["uniq"], np.asarray(u1))
