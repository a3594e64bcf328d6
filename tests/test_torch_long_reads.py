"""Long reads held as paths, past 2^16 of them: each read a window of a
small bubble chain's haplotype walks, some walked backwards, ordered in
contiguous read groups. Built with no crossing matrix (and, past 2^16
paths, no ELL index), the graph takes the routes a chromosome's reads
take at full size: "scan" for a single query, "runs" for a batch. The
answers for whole-group masks are compared element by element with a
plain numpy count of the (path, segment) visits and with the JAX
reference's masked depth on the CPU, and each pass of a scan kernel
counts itself and its padded elements."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pollen_tpu.device import build_device_graph
from pollen_tpu.ops import depth as ref_depth
from pollen_tpu_torch import profiling
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.ops import depth
from pollen_tpu_torch.synth import synth_graph

torch.set_num_threads(1)

SITES = 300
HAPLOTYPES = 4
READS = (1 << 16) + 4_000
GROUPS = 12
Q = 32


def _walks(rng):
    """Haplotype walks of a chain of SITES bubbles: a backbone segment,
    then one of two allele segments, or a loop of 1-20 copies of a third
    (every tenth site). Segment ids in chain order."""
    walks = []
    for _ in range(HAPLOTYPES):
        w = []
        for s in range(SITES):
            w.append(3 * s)
            if s % 10 == 9:
                w += [3 * s + 2] * int(rng.integers(1, 21))
            else:
                w.append(3 * s + 1 + int(rng.integers(0, 2)))
        walks.append(np.array(w, np.int64))
    return walks


def reads_graph(seed=5):
    """(arena, groups): READS reads of 1-16 steps, each a window of a
    walk, a third walked backwards (orientations flipped), in GROUPS
    contiguous groups."""
    rng = np.random.default_rng(seed)
    walks = _walks(rng)
    lens = rng.integers(1, 17, READS)
    hap = rng.integers(0, HAPLOTYPES, READS)
    back = rng.random(READS) < 1 / 3
    reads = []
    for n, h, b in zip(lens, hap, back):
        w = walks[h]
        at = int(rng.integers(0, w.size - n + 1))
        handles = w[at : at + n] << 1
        reads.append((handles[::-1] ^ 1) if b else handles)
    ends = np.cumsum(lens).astype(np.uint32)
    g = dataclasses.replace(
        synth_graph(1, 3 * SITES, READS),
        steps=np.concatenate(reads).astype(np.uint32),
        path_steps=np.stack([ends - lens.astype(np.uint32), ends], axis=1))
    groups = np.arange(READS) * GROUPS // READS
    return g, groups


def plain_counts(g, masks):
    """(depth, uniq) int64[Q, N]: ``np.add.at`` of the selected paths'
    visits, and of their distinct (path, segment) pairs."""
    n = g.num_segments
    seg = (g.steps >> 1).astype(np.int64)
    path = g.step_path_ids().astype(np.int64)
    pairs = np.unique(path * n + seg)
    out_d = np.zeros((len(masks), n), np.int64)
    out_u = np.zeros_like(out_d)
    for q, m in enumerate(masks):
        np.add.at(out_d[q], seg[m[path]], 1)
        np.add.at(out_u[q], (pairs % n)[m[pairs // n]], 1)
    return out_d, out_u


@pytest.fixture(scope="module")
def reads():
    g, groups = reads_graph()
    sizes = np.bincount(groups)
    rng = np.random.default_rng(9)
    sel = rng.random((Q, GROUPS)) < 0.5
    sel[np.arange(Q), rng.integers(0, GROUPS, Q)] = True
    masks = np.repeat(sel, sizes, axis=1)
    return g, build_graph(g, "cpu", cross_matrix="never"), masks


def test_reads_take_the_scan_and_runs_routes(reads):
    g, dg, _ = reads
    assert g.num_paths > 1 << 16
    assert not dg.cross_matrix.numel() and not dg.cross_ell.numel()
    assert depth.masked_route_fn(dg)[0] == "scan"
    assert depth.batch_route(dg) == "runs"


@pytest.mark.parametrize("entry", ["single", "batch"])
def test_whole_group_answers_match_a_plain_count(reads, entry):
    g, dg, masks = reads
    want_d, want_u = plain_counts(g, masks)
    if entry == "single":
        got = [depth.masked_seg_depth(dg, m) for m in masks[:4]]
        got_d, got_u = np.stack([d for d, _ in got]), np.stack([u for _, u in got])
        want_d, want_u = want_d[:4], want_u[:4]
    else:
        got_d, got_u = depth.seg_depth_with_uniq_batch(dg, masks)
    assert got_d.dtype == np.int32 and got_u.dtype == np.int32
    assert np.array_equal(got_d, want_d) and np.array_equal(got_u, want_u)
    # Loops put more than one visit of a read on a segment.
    assert (want_d > want_u).any()


@pytest.mark.parametrize("route", ["scan", "runs"])
def test_answers_match_the_jax_reference(reads, route):
    g, dg, masks = reads
    ref_dg = build_device_graph(g, device="host", cross_matrix="never")
    fn = (ref_depth.seg_depth_with_uniq_masked if route == "scan"
          else ref_depth.seg_depth_with_uniq_runs)
    for m in masks[:2]:
        want = fn(ref_dg, jnp.asarray(m))
        got = (depth.masked_seg_depth(dg, m) if route == "scan"
               else depth.seg_depth_with_uniq_batch(dg, m[None]))
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), np.asarray(b).reshape(-1))


@pytest.mark.parametrize("entry, q", [("single", 1), ("batch", 1), ("batch", Q)])
def test_each_scan_pass_counts_its_elements(reads, entry, q):
    _, dg, masks = reads
    profiling.reset()
    for calls in (1, 2):
        if entry == "single":
            depth.masked_seg_depth(dg, masks[0])
        else:
            depth.seg_depth_with_uniq_batch(dg, masks[:q])
        c = profiling.counters()
        assert c["depth.calls"] == calls
        assert c["depth.scan_passes"] == calls * q
        per = dg.padded_steps if entry == "single" else dg.run_path.shape[0]
        assert c["depth.scan_elements"] == c["depth.scan_passes"] * per
    profiling.reset()


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("fn, size", [
    (depth.seg_depth_with_uniq_fused, lambda dg: dg.padded_steps),
    (depth.seg_depth_with_uniq_runs_fused, lambda dg: dg.run_path.shape[0]),
])
def test_route_parts_count_a_pass_plain_or_not(reads, fn, size, plain):
    _, dg, masks = reads
    profiling.reset()
    fn(dg, torch.from_numpy(masks[1]), plain=plain)
    assert profiling.counters() == {"depth.scan_passes": 1,
                                    "depth.scan_elements": size(dg)}
    profiling.reset()
