"""Port ingest (pollen_tpu_torch.device.build_graph) against the JAX
reference's host ingest, field by field.

Every array must be equal (np.array_equal: integer counts and packed
words, tolerance 0) and every static field identical; the boundary plan
and the router's pick must agree too, so the port routes every graph as
the reference does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import FIXTURE_GRAPHS, GRAPH_DIR
from graphgen import big_step_graph, random_graph
from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import parse_gfa, parse_gfa_file
from pollen_tpu.kernels import gatherb as ref_gatherb
from pollen_tpu.ops import depth as ref_depth
from pollen_tpu_torch.device import (
    META_FIELDS,
    TENSOR_FIELDS,
    build_graph,
    from_host_arrays,
)
from pollen_tpu_torch.kernels import gatherb
from pollen_tpu_torch.ops import depth as port_depth
from pollen_tpu_torch.synth import synth_graph

torch.set_num_threads(1)

GENERATED = {
    "gen_rand_s0": lambda: random_graph(n_segs=60, n_paths=8, seed=0),
    "gen_rand_s3": lambda: random_graph(n_segs=200, n_paths=24, seed=3),
    "gen_rand_olap": lambda: random_graph(
        n_segs=40, n_paths=5, seed=5, with_overlap_col=True
    ),
    "gen_bigstep": lambda: big_step_graph(300, 6000, 12, seed=2),
}
SYNTH = {
    "synth_p96": (2**16, 2**12, 96),
    "synth_p300": (2**16, 2**12, 300),
}


def load_case(name: str):
    if name in GENERATED:
        return parse_gfa(GENERATED[name]().encode())
    if name in SYNTH:
        return synth_graph(*SYNTH[name])
    return parse_gfa_file(str(GRAPH_DIR / name))


CASES = FIXTURE_GRAPHS + sorted(GENERATED) + sorted(SYNTH)


def assert_same_graph(ref, port):
    for f in TENSOR_FIELDS:
        a = np.asarray(getattr(ref, f))
        b = getattr(port, f).numpy()
        assert a.shape == b.shape, (f, a.shape, b.shape)
        assert np.array_equal(a, b), f
    for f in META_FIELDS:
        assert getattr(ref, f) == getattr(port, f), f
    assert ref.padded_steps == port.padded_steps
    assert ref.num_steps == port.num_steps


@pytest.mark.parametrize("objective", ["single", "batch"])
@pytest.mark.parametrize("case", CASES)
def test_build_graph_matches_reference(case, objective):
    g = load_case(case)
    ref = build_device_graph(g, device="host", ell_objective=objective)
    port = build_graph(g, "cpu", ell_objective=objective)
    assert_same_graph(ref, port)
    assert port_depth._best_masked_impl(port) == ref_depth._best_masked_impl(
        ref
    )
    assert port_depth._masked_impl_costs(port) == (
        ref_depth._masked_impl_costs(ref)
    )


@pytest.mark.parametrize("case", CASES)
def test_plan_boundary_matches_reference(case):
    g = load_case(case)
    port = build_graph(g, "cpu")
    for bounds, length in (
        (port.seg_bounds.numpy(), port.padded_steps),
        (port.run_seg_bounds.numpy(), port.run_path.shape[0]),
    ):
        a = ref_gatherb.plan_boundary(bounds, length)
        b = gatherb.plan_boundary(bounds, length)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert np.array_equal(x, y), f.name
            else:
                assert x == y, f.name


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(minimal=True),
        dict(cross_matrix="never"),
        dict(cross_matrix="always"),
    ],
    ids=["minimal", "cross_never", "cross_always"],
)
def test_build_graph_options_match_reference(kwargs):
    g = synth_graph(2**15, 2**11, 64)
    assert_same_graph(
        build_device_graph(g, device="host", **kwargs),
        build_graph(g, "cpu", **kwargs),
    )


@pytest.mark.parametrize(
    "env",
    [
        {"POLLEN_ELL_PACK16": "0"},
        {"POLLEN_CROSS_BUDGET_MB": "0.05"},
        {"POLLEN_ELL_OBJECTIVE": "batch"},
    ],
    ids=["pack16_off", "small_budget", "objective_env"],
)
def test_build_graph_env_knobs_match_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    g = synth_graph(2**15, 2**11, 64)
    assert_same_graph(
        build_device_graph(g, device="host"), build_graph(g, "cpu")
    )


def test_from_host_arrays_equals_build_graph():
    g = synth_graph(2**15, 2**11, 96)
    ref = build_device_graph(g, device="host")
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    carried = from_host_arrays(fields, "cpu")
    built = build_graph(g, "cpu")
    for f in TENSOR_FIELDS:
        a, b = getattr(carried, f), getattr(built, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for f in META_FIELDS:
        assert getattr(carried, f) == getattr(built, f), f
    assert carried.to("cpu").device.type == "cpu"


def test_build_graph_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    g = parse_gfa_file(str(GRAPH_DIR / "tiny.gfa"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_graph(g, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_graph(g, "cpu").to("cuda")
