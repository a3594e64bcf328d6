"""The port's public masked-depth queries take what the reference's
take: numpy masks, single and (Q, P), bool or 0/1, as well as tensors.

The same seeded masks go through the JAX reference (on the CPU, its
plain forms) and the port's query on the CPU, each mask given as a
numpy bool array, a numpy 0/1 array, a bool tensor and an int32 tensor;
every answer must equal the reference's, int32 and exact (tolerance 0).
The graphs are the fixtures and one ``graphgen`` graph of 40 paths, past
one 32-bit mask word.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXTURE_GRAPHS, GRAPH_DIR
from graphgen import random_graph
from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import parse_gfa, parse_gfa_file
from pollen_tpu.ops import depth as ref_depth
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.ops import depth as port_depth

torch.set_num_threads(1)

GEN = "graphgen_p40"
CASES = FIXTURE_GRAPHS + [GEN]
QUERIES = ("masked", "ell_permuted", "batch", "routed")
FORMS = {
    "numpy bool": lambda m: m,
    "numpy 0/1": lambda m: m.astype(np.int64),
    "tensor bool": torch.from_numpy,
    "tensor int32": lambda m: torch.from_numpy(m.astype(np.int32)),
}


@functools.lru_cache(maxsize=None)
def graphs(case):
    if case == GEN:
        text = random_graph(n_segs=300, n_paths=40, seed=15, walk_len=60)
        g = parse_gfa(text.encode())
    else:
        g = parse_gfa_file(str(GRAPH_DIR / case))
    return g, build_device_graph(g, device="host"), build_graph(g, "cpu")


def seeded_masks(p, seed=5):
    """A (Q, P) bool stack: all, none, every other path, two seeded."""
    rng = np.random.default_rng(seed)
    rows = [np.ones(p, bool), np.zeros(p, bool), np.arange(p) % 2 == 0]
    rows += [rng.random(p) < f for f in (0.5, 0.25)]
    return np.stack(rows)


def ref_routed(ref_dg, mask):
    """The reference's routed single query on the CPU
    (pollen_tpu/ops/depth.py run_seg_depth, off the TPU)."""
    best = ref_depth._best_masked_impl(ref_dg)
    if best == "ell":
        return ref_depth.seg_depth_with_uniq_ell(ref_dg, mask, pallas=False)
    if best == "cross":
        return ref_depth.seg_depth_with_uniq_cross(ref_dg, mask, pallas=False)
    if ref_dg.run_path.shape[0]:
        return ref_depth.seg_depth_with_uniq_runs(ref_dg, mask)
    return ref_depth.seg_depth_with_uniq_masked(ref_dg, mask)


def ref_answers(query, ref_dg, masks):
    """The reference's (depth, uniq) per mask row (Q, N), host int."""
    if query == "batch":
        d, u = ref_depth.seg_depth_with_uniq_batch(ref_dg, jnp.asarray(masks))
        return np.asarray(d), np.asarray(u)
    fn = {
        "masked": ref_depth.seg_depth_with_uniq_masked,
        "ell_permuted": ref_depth.seg_depth_with_uniq_ell_permuted,
        "routed": ref_routed,
    }[query]
    pairs = [fn(ref_dg, jnp.asarray(m)) for m in masks]
    return (np.stack([np.asarray(d) for d, _ in pairs]),
            np.stack([np.asarray(u) for _, u in pairs]))


def port_answers(query, dg, masks, form):
    if query == "batch":
        return port_depth.seg_depth_with_uniq_batch(dg, form(masks))
    fn = {
        "masked": port_depth.seg_depth_with_uniq_masked,
        "ell_permuted": port_depth.seg_depth_with_uniq_ell_permuted,
        "routed": port_depth.masked_seg_depth,
    }[query]
    pairs = [fn(dg, form(m)) for m in masks]
    return [d for d, _ in pairs], [u for _, u in pairs]


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("case", CASES)
def test_numpy_and_tensor_masks_match_reference(case, query):
    g, ref_dg, dg = graphs(case)
    if case == GEN:
        assert g.num_paths > 32
    if query == "ell_permuted":
        assert ref_dg.cross_ell.size and dg.cross_ell.numel()
    masks = seeded_masks(g.num_paths)
    want_d, want_u = ref_answers(query, ref_dg, masks)
    for name, form in FORMS.items():
        got_d, got_u = port_answers(query, dg, masks, form)
        for q in range(masks.shape[0]):
            for got, want in ((got_d[q], want_d[q]), (got_u[q], want_u[q])):
                got = np.asarray(got)
                assert got.dtype == np.int32, (name, q)
                assert np.array_equal(got, want), (name, q)
