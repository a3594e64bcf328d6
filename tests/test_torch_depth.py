"""The port's masked segment-depth slice end to end, against the JAX
reference on the CPU: per-class ELL parts, the cross / runs / scan
routes, the router's end result, path depth, and the goldens through
``fgfa-torch --device cpu``. Both the port's own ingest and a state
carried over from the reference's host ingest (from_host_arrays) are
queried. All comparisons are exact (integer counts, tolerance 0; text
byte for byte).
"""

import dataclasses
import io
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXTURE_GRAPHS, GOLDEN_DIR, GRAPH_DIR
from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import GraphArrays, parse_gfa_file
from pollen_tpu.kernels import ellscan as ref_ellscan
from pollen_tpu.ops import depth as ref_depth
from pollen_tpu_torch import cli
from pollen_tpu_torch.device import build_graph, from_host_arrays
from pollen_tpu_torch.kernels import ellscan as port_ellscan
from pollen_tpu_torch.ops import depth as port_depth
from pollen_tpu_torch.synth import synth_graph

torch.set_num_threads(1)

SYNTH = {
    "synth_p96": (2**16, 2**12, 96),
    "synth_p300": (2**16, 2**12, 300),
    # Over 8192 heavy columns: the heavy block is SEG_BLOCK padded, so
    # the fused split path (K1) is taken.
    "synth_fused": (2**20, 2**16, 128),
    # Routes "ell" with a heavy block below SEG_BLOCK: the unfused path.
    "synth_unfused": (2**19, 2**16, 96),
}
CASES = FIXTURE_GRAPHS + sorted(SYNTH)


def three_tier_graph(n1=40000, n2=40000, n3=20000, nh=200, p=64):
    """Runs per segment 1, 4, 16 and 40 by block: with the fixed and
    per-column costs zeroed the planner picks three tiers plus heavy."""
    n = n1 + n2 + n3 + nh
    segs, paths = [], []
    for base, count, r in (
        (0, n1, 1),
        (n1, n2, 4),
        (n1 + n2, n3, 16),
        (n1 + n2 + n3, nh, 40),
    ):
        s = np.arange(base, base + count, dtype=np.int64)
        for i in range(r):
            segs.append(s)
            paths.append((s + i) % p)
    seg, pth = np.concatenate(segs), np.concatenate(paths)
    order = np.argsort(pth, kind="stable")
    seg, pth = seg[order], pth[order]
    bounds = np.concatenate(
        ([0], np.cumsum(np.bincount(pth, minlength=p)))
    ).astype(np.uint32)
    sb = np.arange(n + 1, dtype=np.uint32)
    names = [f"t{i}".encode() for i in range(p)]
    ends = np.cumsum([len(b) for b in names]).astype(np.uint32)
    return GraphArrays(
        header=np.zeros(0, np.uint8),
        seg_name=np.arange(1, n + 1, dtype=np.int64),
        seg_seq=np.stack([sb[:-1], sb[1:]], axis=1),
        seg_optional=np.zeros((n, 2), np.uint32),
        path_name=np.stack([np.concatenate(([0], ends[:-1])), ends], axis=1)
        .astype(np.uint32),
        path_steps=np.stack([bounds[:-1], bounds[1:]], axis=1),
        path_overlaps=np.zeros((p, 2), np.uint32),
        link_from=np.zeros(0, np.uint32),
        link_to=np.zeros(0, np.uint32),
        link_overlap=np.zeros((0, 2), np.uint32),
        steps=(seg.astype(np.uint32) << np.uint32(1)),
        seq_data=np.zeros(n, np.uint8),
        overlaps=np.zeros((0, 2), np.uint32),
        alignment=np.zeros(0, np.uint32),
        name_data=np.frombuffer(b"".join(names), np.uint8).copy(),
        optional_data=np.zeros(0, np.uint8),
        line_order=np.zeros(0, np.uint8),
    )


def load_case(name):
    if name in SYNTH:
        return synth_graph(*SYNTH[name])
    return parse_gfa_file(str(GRAPH_DIR / name))


def masks_for(p, seed=0):
    rng = np.random.default_rng(seed)
    out = [np.ones(p, bool), np.zeros(p, bool)]
    out += [rng.random(p) < 0.5 for _ in range(2)]
    return out


def both_port_graphs(ref_dg, g):
    fields = {f.name: getattr(ref_dg, f.name) for f in dataclasses.fields(ref_dg)}
    return {
        "carried": from_host_arrays(fields, "cpu"),
        "built": build_graph(g, "cpu"),
    }


def assert_parts_equal(ref_parts, port_parts):
    assert len(ref_parts) == len(port_parts) == 6
    for a, b in zip(ref_parts, port_parts):
        assert (a is None) == (b is None)
        if a is not None:
            assert b.dtype == torch.int32
            assert np.array_equal(np.asarray(a), b.numpy())


def check_ell_slice(g, ref_dg):
    for how, dg in both_port_graphs(ref_dg, g).items():
        for m in masks_for(g.num_paths):
            ref_parts = ref_depth.seg_depth_with_uniq_ell_parts(
                ref_dg, jnp.asarray(m), pallas=False
            )
            mt = torch.from_numpy(m)
            for plain in (True, False):
                assert_parts_equal(
                    ref_parts,
                    port_depth.seg_depth_with_uniq_ell_parts(dg, mt, plain=plain),
                )
            d_r, u_r = ref_depth.seg_depth_with_uniq_ell(
                ref_dg, jnp.asarray(m), pallas=False
            )
            d_p, u_p = port_depth.seg_depth_with_uniq_ell(dg, mt)
            assert np.array_equal(np.asarray(d_r), d_p.numpy()), how
            assert np.array_equal(np.asarray(u_r), u_p.numpy()), how


@pytest.mark.parametrize("case", CASES)
def test_ell_slice_matches_reference(case):
    g = load_case(case)
    ref_dg = build_device_graph(g, device="host")
    assert ref_dg.cross_ell.size
    if case == "synth_fused":
        assert ref_dg.ell_heavy.shape[1] % 8192 == 0
        assert ref_dg.ell_heavy_res.size  # the clip residual is in play
    check_ell_slice(g, ref_dg)


def test_three_tier_slice_matches_reference(monkeypatch):
    for mod in (ref_ellscan, port_ellscan):
        monkeypatch.setattr(mod, "C_TIER_FIXED", 0.0)
        monkeypatch.setattr(mod, "C_COL_B", 0.0)
    g = three_tier_graph()
    ref_dg = build_device_graph(g, device="host")
    assert ref_dg.ell_k3 > 0 and ref_dg.ell_num_mid2 > 0
    check_ell_slice(g, ref_dg)


@pytest.mark.parametrize("case", CASES)
def test_cross_and_scan_routes_match_reference(case):
    g = load_case(case)
    ref_dg = build_device_graph(g, device="host")
    dg = build_graph(g, "cpu")
    for m in masks_for(g.num_paths, seed=1):
        mj, mt = jnp.asarray(m), torch.from_numpy(m)
        pairs = [
            (
                ref_depth.seg_depth_with_uniq_runs(ref_dg, mj),
                port_depth.seg_depth_with_uniq_runs(dg, mt),
            ),
            (
                ref_depth.seg_depth_with_uniq_masked(ref_dg, mj),
                port_depth.seg_depth_with_uniq_masked(dg, mt),
            ),
        ]
        if ref_dg.cross_matrix.size:
            ref_x = ref_depth.seg_depth_with_uniq_cross(ref_dg, mj)
            pairs += [
                (ref_x, port_depth.seg_depth_with_uniq_cross(dg, mt, plain=p))
                for p in (True, False)
            ]
        for (d_r, u_r), (d_p, u_p) in pairs:
            assert np.array_equal(np.asarray(d_r), d_p.numpy())
            assert np.array_equal(np.asarray(u_r), u_p.numpy())


@pytest.mark.parametrize("case", CASES)
def test_run_seg_depth_matches_reference(case):
    """The routed, rendered query: all paths and two subsets."""
    g = load_case(case)
    ref_dg = build_device_graph(g, device="host")
    dg = build_graph(g, "cpu")
    names = [b.decode() for b in g.path_names()]
    subsets = [None, names[::2], names[1:2]]
    for subset in subsets:
        assert port_depth.run_seg_depth(g, dg, subset) == (
            ref_depth.run_seg_depth(g, ref_dg, subset)
        )


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_path_depth_matches_reference(case):
    g = load_case(case)
    ref_dg = build_device_graph(g, device="host")
    dg = build_graph(g, "cpu")
    l_r, s_r = ref_depth.path_depth(ref_dg)
    l_p, s_p = port_depth.path_depth(dg)
    assert np.array_equal(np.asarray(l_r), l_p.numpy())
    assert np.array_equal(np.asarray(s_r), s_p.numpy())
    names = [b.decode() for b in g.path_names()]
    for paths in (None, names[:1]):
        assert port_depth.run_path_depth(g, dg, paths) == (
            ref_depth.run_path_depth(g, ref_dg, paths)
        )


def run_cli(argv, stdin_text=""):
    out = io.StringIO()
    cli.main(argv, stdin=io.StringIO(stdin_text), stdout=out)
    return out.getvalue()


@pytest.mark.parametrize("case", FIXTURE_GRAPHS)
def test_goldens_through_cli(case):
    stem = case[: -len(".gfa")]
    gfa = str(GRAPH_DIR / case)
    assert run_cli(["--device", "cpu", "-I", gfa, "depth", "-d"]) == (
        GOLDEN_DIR / f"{stem}.depth"
    ).read_text()
    subset = str(GOLDEN_DIR / f"{stem}.depthpaths")
    assert run_cli(
        ["--device", "cpu", "-I", gfa, "depth", "-d", "-s", subset]
    ) == (GOLDEN_DIR / f"{stem}.depth_subset").read_text()


def test_serve_answers_and_frames():
    gfa = str(GRAPH_DIR / "tiny.gfa")
    requests = "\n".join(
        [
            "depth -d",
            f"depth -d -s {GOLDEN_DIR / 'tiny.depthpaths'}",
            "depth",
            "gaf reads.gaf",  # a GAF file that is not there
            "depth -S nowhere.txt",
            "no-such-command",
        ]
    )
    with contextlib.redirect_stderr(io.StringIO()):
        text = run_cli(["--device", "cpu", "-I", gfa, "serve"], requests)
    frames = [ln for ln in text.splitlines() if ln.startswith("##end")]
    assert frames[:3] == ["##end\tok"] * 3
    assert frames[3].startswith("##end\terror\t") and "reads.gaf" in frames[3]
    assert frames[4].startswith("##end\terror\t") and "nowhere.txt" in frames[4]
    assert frames[5] == "##end\terror\tbad request"
    golden = (GOLDEN_DIR / "tiny.depth").read_text()
    assert text.startswith(golden + "##end\tok\n")


def test_cli_refuses_unported_and_missing_cuda(capsys):
    """Every command is ported (nothing answers "not ported yet"); on a
    machine with no card, ``--device cuda`` (the default) is an error
    for ``fgfa-torch`` and ``exine-torch``, never a quiet CPU run."""
    from pollen_tpu_torch.accel.__main__ import main as exine_main

    gfa = str(GRAPH_DIR / "tiny.gfa")
    with pytest.raises(SystemExit) as exc:
        run_cli(["--device", "cpu", "-I", gfa, "gaf", "reads.gaf"])
    assert exc.value.code == 1
    err = capsys.readouterr().err
    assert "reads.gaf" in err and "not ported" not in err
    if torch.cuda.is_available():
        return  # the rest checks a machine with no card
    with pytest.raises(SystemExit) as exc:
        run_cli(["--device", "cuda", "-I", gfa, "depth", "-d"])
    assert exc.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        run_cli(["-I", gfa, "depth", "-d"])  # cuda is the default
    with pytest.raises(SystemExit) as exc:
        exine_main(["--device", "cuda", "depth", "-a", "-r", gfa])
    assert exc.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err
