"""The port's graph commands beyond depth (degree, flatten, validate,
position, overlap, flip's vote, window depth) against the JAX reference
on the CPU: each device op against the reference's jitted function on
the fixtures and on seeded generated graphs, and each command's stdout
through ``fgfa-torch --device cpu`` against ``pollen_tpu.cli.main`` and
the goldens. Every comparison is exact (integers and booleans equal,
float64 window depths equal bit for bit, text byte for byte).
"""

import contextlib
import dataclasses
import io
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXTURE_GRAPHS, GOLDEN_DIR, GRAPH_DIR
from graphgen import big_step_graph, random_graph
from pollen_tpu import cli as ref_cli
from pollen_tpu.bed import windows_bed as ref_windows_bed
from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import parse_gfa as ref_parse_gfa
from pollen_tpu.ops import degree as ref_degree
from pollen_tpu.ops import flatten as ref_flatten
from pollen_tpu.ops import overlap as ref_overlap
from pollen_tpu.ops import position as ref_position
from pollen_tpu.ops import transform as ref_transform
from pollen_tpu.ops import validate as ref_validate
from pollen_tpu.ops import window_depth as ref_window_depth
from pollen_tpu_torch import cli as port_cli
from pollen_tpu_torch.bed import windows_bed
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.flatgfa import parse_gfa
from pollen_tpu_torch.ops import degree as port_degree
from pollen_tpu_torch.ops import flatten as port_flatten
from pollen_tpu_torch.ops import overlap as port_overlap
from pollen_tpu_torch.ops import position as port_position
from pollen_tpu_torch.ops import transform as port_transform
from pollen_tpu_torch.ops import validate as port_validate
from pollen_tpu_torch.ops import window_depth as port_window_depth

torch.set_num_threads(1)

GENERATED = {
    "gen_rand_s0": lambda: random_graph(n_segs=60, n_paths=8, seed=0),
    "gen_rand_s3": lambda: random_graph(n_segs=200, n_paths=24, seed=3),
    "gen_rand_olap": lambda: random_graph(
        n_segs=40, n_paths=5, seed=5, with_overlap_col=True
    ),
    "gen_bigstep": lambda: big_step_graph(300, 6000, 12, seed=2),
}
CASES = FIXTURE_GRAPHS + sorted(GENERATED)


def gfa_text(name: str) -> bytes:
    if name in GENERATED:
        return GENERATED[name]().encode()
    return (GRAPH_DIR / name).read_bytes()


@pytest.fixture(scope="module", params=CASES)
def pair(request):
    """(reference arena, reference device graph, port arena, port graph)
    of one case, each package parsing the same text."""
    data = gfa_text(request.param)
    g_ref = ref_parse_gfa(data)
    g = parse_gfa(data)
    return (
        g_ref,
        build_device_graph(g_ref, cross_matrix="never"),
        g,
        build_graph(g, "cpu", cross_matrix="never"),
    )


def test_seg_degree_matches_reference(pair):
    _, dg_ref, _, dg = pair
    want = np.asarray(ref_degree.seg_degree(dg_ref))
    got = port_degree.seg_degree(dg)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_step_intervals_match_reference(pair):
    _, dg_ref, _, dg = pair
    for want, got in zip(
        ref_flatten.step_intervals(dg_ref), port_flatten.step_intervals(dg)
    ):
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), np.asarray(want))


def drop_links(g, seed: int):
    """The arena with a seeded quarter of its links dropped, so that
    validate has pairs to report."""
    rng = np.random.default_rng(seed)
    keep = rng.random(g.num_links) >= 0.25
    return dataclasses.replace(
        g,
        link_from=g.link_from[keep],
        link_to=g.link_to[keep],
        link_overlap=g.link_overlap[keep],
    )


@pytest.mark.parametrize("dropped", [False, True], ids=["all_links", "dropped"])
def test_unsupported_pairs_match_reference(pair, dropped):
    g_ref, _, g, _ = pair
    if dropped:
        g_ref, g = drop_links(g_ref, 1), drop_links(g, 1)
    assert g.num_steps >= 2
    want = np.asarray(
        ref_validate._unsupported_pairs(
            jnp.asarray(g_ref.steps),
            jnp.asarray(g_ref.step_path_ids()),
            jnp.asarray(ref_validate.link_keys(g_ref)),
        )
    )
    got = port_validate._unsupported_pairs(
        torch.from_numpy(g.steps.astype(np.int64)),
        torch.from_numpy(g.step_path_ids()),
        torch.from_numpy(port_validate.link_keys(g)),
    )
    assert np.array_equal(got.numpy(), want)
    assert port_validate.run_validate(g, "cpu") == ref_validate.run_validate(
        g_ref
    )


def signed(keys_u64: np.ndarray) -> np.ndarray:
    """The uint64 keys with the sign bit flipped, read as int64."""
    return (keys_u64 ^ np.uint64(1 << 63)).view(np.int64)


def test_validate_keys_with_handles_past_2_31():
    """Handles >= 2^31 (graphs of >= 2^30 segments): a plain int64
    ``from << 32`` would go negative and sort first; the sign-flipped
    keys keep the reference's uint64 order, and the probe answers as
    the reference's does."""
    rng = np.random.default_rng(31)
    big = np.uint64(2**32 - 1)
    handles = np.concatenate(
        [
            rng.integers(0, 2**31, 40, dtype=np.uint64),
            rng.integers(2**31, 2**32, 40, dtype=np.uint64),
            np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, big - 1, big],
                     np.uint64),
        ]
    ).astype(np.uint32)
    steps = rng.permutation(np.concatenate([handles, handles[::-1]]))
    a, b = steps[:-1], steps[1:]
    pick = rng.random(a.shape[0]) < 0.5
    flip = rng.random(a.shape[0]) < 0.5
    # Links for half of the adjacent pairs, some of them stored reversed.
    lf = np.where(flip, b ^ 1, a)[pick]
    lt = np.where(flip, a ^ 1, b)[pick]
    arena = types.SimpleNamespace(link_from=lf, link_to=lt)
    ref_keys = ref_validate.link_keys(arena)
    port_keys = port_validate.link_keys(arena)
    assert (port_keys < 0).any() and (port_keys >= 0).any()
    assert np.array_equal(port_keys, signed(ref_keys))
    assert np.array_equal(np.argsort(port_keys, kind="stable"),
                          np.argsort(ref_keys, kind="stable"))
    step_path = (np.arange(steps.shape[0]) * 3 // steps.shape[0]).astype(
        np.int32
    )
    want = np.asarray(
        ref_validate._unsupported_pairs(
            jnp.asarray(steps), jnp.asarray(step_path), jnp.asarray(ref_keys)
        )
    )
    got = port_validate._unsupported_pairs(
        torch.from_numpy(steps.astype(np.int64)),
        torch.from_numpy(step_path),
        torch.from_numpy(port_keys),
    )
    assert want.any() and not want.all()
    assert np.array_equal(got.numpy(), want)


def test_unsupported_pairs_without_links():
    """A graph with no links: every same-path pair is unsupported (the
    reference's ``keys.shape[0] == 0`` branch)."""
    steps = np.array([2, 4, 7, 6, 2], np.uint32)
    step_path = np.array([0, 0, 0, 1, 1], np.int32)
    want = np.asarray(
        ref_validate._unsupported_pairs(
            jnp.asarray(steps), jnp.asarray(step_path),
            jnp.zeros(0, jnp.uint64),
        )
    )
    got = port_validate._unsupported_pairs(
        torch.from_numpy(steps.astype(np.int64)),
        torch.from_numpy(step_path),
        torch.zeros(0, dtype=torch.int64),
    )
    assert np.array_equal(got.numpy(), want)
    assert got.tolist() == [True, True, False, True]


def test_positions_in_path_match_reference(pair):
    """Every offset of every path, and offsets past its end (invalid
    rows too: handles and in-segment offsets are the reference's)."""
    g_ref, dg_ref, g, dg = pair
    for p in range(g.num_paths):
        lo, hi = g.path_steps[p]
        total = int(g.seg_len[(g.steps[lo:hi] >> 1).astype(np.int64)].sum())
        offsets = np.concatenate(
            [np.arange(total + 3), [total + 1000, 2**40]]
        ).astype(np.int64)
        want = ref_position.positions_in_path(
            dg_ref, jnp.asarray(p, dtype=jnp.int32), jnp.asarray(offsets)
        )
        got = port_position.positions_in_path(dg, p, torch.from_numpy(offsets))
        for w, o in zip(want, got):
            assert np.array_equal(o.numpy(), np.asarray(w).astype(o.numpy().dtype))
        valid = got[2].numpy()
        assert valid[:total].all() and not valid[total:].any()


def test_position_past_path_end_prints_nothing():
    data = (GRAPH_DIR / "tiny.gfa").read_bytes()
    g_ref = ref_parse_gfa(data)
    g = parse_gfa(data)
    dg_ref = build_device_graph(g_ref, cross_matrix="never")
    dg = build_graph(g, "cpu", cross_matrix="never")
    for p in range(g.num_paths):
        name = g.path_name_bytes(p).decode()
        lo, hi = g.path_steps[p]
        total = int(g.seg_len[(g.steps[lo:hi] >> 1).astype(np.int64)].sum())
        for off in (0, total - 1, total, total + 5):
            got = port_position.run_position(g, dg, name, off)
            assert got == ref_position.run_position(g_ref, dg_ref, name, off)
            assert (got is None) == (off >= total)
    with pytest.raises(KeyError):
        port_position.run_position(g, dg, "no-such-path", 0)


def test_position_on_an_empty_path():
    """An empty path's lookup clamps every gather as JAX does: no valid
    offset, no index error. In a graph with no steps at all the
    reference's gathers from empty arrays raise; the port answers that
    no offset is on the path."""
    g0 = parse_gfa(b"S\t1\tACG\nP\tx\t\t*\n")
    dg0 = build_graph(g0, "cpu", cross_matrix="never")
    assert port_position.run_position(g0, dg0, "x", 0) is None
    data = b"S\t1\tACG\nS\t2\tT\nP\tx\t1+,2-\t*\nP\ty\t\t*\n"
    g_ref = ref_parse_gfa(data)
    g = parse_gfa(data)
    dg_ref = build_device_graph(g_ref, cross_matrix="never")
    dg = build_graph(g, "cpu", cross_matrix="never")
    offsets = np.array([0, 1, 7], np.int64)
    for p in range(2):
        want = ref_position.positions_in_path(
            dg_ref, jnp.asarray(p, dtype=jnp.int32), jnp.asarray(offsets)
        )
        got = port_position.positions_in_path(dg, p, torch.from_numpy(offsets))
        for w, o in zip(want, got):
            assert np.array_equal(o.numpy(), np.asarray(w).astype(o.numpy().dtype))


def test_touch_matrix_matches_reference(pair):
    g_ref, _, g, dg = pair
    inc_ref = ref_overlap._incidence(g_ref)
    inc = port_overlap._incidence(g, dg)
    assert inc.dtype == torch.bool
    assert np.array_equal(inc.numpy(), inc_ref)
    want = np.asarray(ref_overlap._touch_matrix(jnp.asarray(inc_ref)))
    assert np.array_equal(port_overlap._touch_matrix(inc).numpy(), want)


def test_touch_matrix_exact_past_bf16_integers():
    """Shared counts past bf16's exact integers (256) and single shared
    handles: the ``> 0`` test of the bf16 product stays exact."""
    rng = np.random.default_rng(7)
    n = 4096
    inc = np.zeros((6, n), bool)
    inc[0, :2000] = True
    inc[1, 1000:3001] = True  # shares 1000 with path 0
    inc[2, 3000] = True  # shares one handle with path 1
    inc[3, 3500:3600] = True  # shares nothing
    inc[4] = rng.random(n) < 0.6
    inc[5, 4095] = inc[4, 4095]
    want = (inc.astype(np.float64) @ inc.T.astype(np.float64)) > 0
    want &= ~np.eye(6, dtype=bool)
    got = port_overlap._touch_matrix(torch.from_numpy(inc)).numpy()
    assert np.array_equal(got, want)
    ref = np.asarray(ref_overlap._touch_matrix(jnp.asarray(inc)))
    assert np.array_equal(got, ref)


def test_reverse_heavy_paths_match_reference(pair):
    _, dg_ref, _, dg = pair
    want = np.asarray(ref_transform._reverse_heavy_paths(dg_ref))
    assert np.array_equal(
        port_transform._reverse_heavy_paths(dg).numpy(), want
    )


@pytest.mark.parametrize("window", [1, 3, 10])
def test_interval_depth_matches_reference(pair, window):
    """Window depths, float64, bit for bit on every path."""
    g_ref, dg_ref, g, dg = pair
    for p in range(g.num_paths):
        name = g.path_name_bytes(p)
        lo, hi = g.path_steps[p]
        length = int(g.seg_len[(g.steps[lo:hi] >> 1).astype(np.int64)].sum())
        want = ref_window_depth.interval_depth(
            g_ref, dg_ref, p, ref_windows_bed(name, 0, length, window)
        )
        got = port_window_depth.interval_depth(
            g, dg, p, windows_bed(name, 0, length, window)
        )
        assert got.dtype == np.float64
        assert np.array_equal(got.view(np.int64), want.view(np.int64))


def test_overlap_keys_match_reference(pair):
    """flip's link-overlap factorization numbers the keys as the
    reference's does."""
    g_ref, _, g, _ = pair
    for extra in (0, 3):
        assert np.array_equal(
            port_transform._overlap_keys(g, extra),
            ref_transform._overlap_keys(g_ref, extra),
        )


# ---------------------------------------------------------------------------
# The commands, through both CLIs
# ---------------------------------------------------------------------------


def ref_run(argv, stdin_text=""):
    out = io.StringIO()
    old_stdin = ref_cli.sys.stdin
    ref_cli.sys.stdin = io.StringIO(stdin_text)
    try:
        with contextlib.redirect_stdout(out):
            ref_cli.main(argv)
    finally:
        ref_cli.sys.stdin = old_stdin
    return out.getvalue()


def port_run(argv, stdin_text=""):
    out = io.StringIO()
    port_cli.main(["--device", "cpu", *argv], stdin=io.StringIO(stdin_text),
                  stdout=out)
    return out.getvalue()


def first_path(stem: str) -> str:
    return (GOLDEN_DIR / f"{stem}.paths").read_text().split()[0]


def command_lines(stem: str, tmp) -> list:
    """(argv, golden file or None) of every command of this slice."""
    paths = tmp / f"{stem}.allpaths"
    paths.write_text((GOLDEN_DIR / f"{stem}.paths").read_text())
    bed = str(GOLDEN_DIR / f"{stem}.bed")
    p0 = first_path(stem)
    return [
        (["degree"], "degree"),
        (["flatten"], "flatten"),
        (["overlap", "--paths", str(paths)], "overlap"),
        (["validate"], "validate"),
        (["matrix-adj"], "matrix"),
        (["paths"], "paths"),
        (["norm"], "norm"),
        (["crush"], "crush"),
        (["flip"], "flip"),
        (["chop", "-c", "3"], "chop"),
        ([], None),
        (["stats"], None),
        (["stats", "-L"], None),
        (["toc"], None),
        (["toc", "-b"], None),
        (["position", "-p", f"{p0},0,+"], None),
        (["position", "-p", f"{p0},3,+"], None),
        (["position", "-p", f"{p0},100000,+"], None),
        (["depth", "-b", bed], None),
        (["depth", "-b", bed, "-S", str(paths)], None),
        (["window-depth", p0, "2"], None),
        (["window-depth", p0, "7"], None),
        (["bed-depth", "-b", bed], None),
        (["bed", "-a", bed, "-b", bed], None),
        (["chop", "-c", "2", "-l"], None),
    ]


@pytest.mark.parametrize("stem", [f[:-4] for f in FIXTURE_GRAPHS])
def test_commands_match_reference_and_goldens(stem, tmp_path, monkeypatch):
    """Flatten's FASTA name comes from the input path, so both CLIs run
    from the repository root on ``tests/graphs/<stem>.gfa``."""
    monkeypatch.chdir(GRAPH_DIR.parent.parent)
    gfa = f"tests/graphs/{stem}.gfa"
    for argv, golden in command_lines(stem, tmp_path):
        got = port_run(["-I", gfa, *argv])
        assert got == ref_run(["-I", gfa, *argv]), argv
        if golden:
            assert got == (GOLDEN_DIR / f"{stem}.{golden}").read_text(), argv
    assert port_run(["-I", gfa]) == (GRAPH_DIR / f"{stem}.gfa").read_text()


@pytest.mark.parametrize("stem", [f[:-4] for f in FIXTURE_GRAPHS])
def test_validate_broken_matches_golden(stem, tmp_path):
    broken = tmp_path / f"{stem}.broken.gfa"
    broken.write_text((GOLDEN_DIR / f"{stem}.validate_setup").read_text())
    got = port_run(["-I", str(broken), "validate"])
    assert got == (GOLDEN_DIR / f"{stem}.validate_broken").read_text()
    assert got == ref_run(["-I", str(broken), "validate"])


@pytest.mark.parametrize("stem", ["tiny", "rand1", "loops"])
def test_serve_answers_every_command_as_the_reference(stem, tmp_path,
                                                       monkeypatch):
    """One serve stream mixing every command of this slice with depth
    requests and bad ones, answered as the reference's serve does."""
    monkeypatch.chdir(GRAPH_DIR.parent.parent)
    gfa = f"tests/graphs/{stem}.gfa"
    requests = [" ".join(argv) for argv, _ in command_lines(stem, tmp_path)
                if argv]
    requests += ["depth -d", "position -p nope", "serve", "bench",
                 "depth -d -s " + str(GOLDEN_DIR / f"{stem}.depthpaths"),
                 "overlap --paths /no/such/file", "window-depth nope 3"]
    text = "\n".join(requests) + "\n"
    got = port_run(["-I", gfa, "serve"], text)
    assert got == ref_run(["-I", gfa, "serve"], text)
    assert got.count("##end\tok\n") == len(requests) - 5


def test_unported_commands_exit_not_ported(tmp_path):
    """The eight command lines that once exited "not ported yet" (gaf,
    matrix, pangenotype, extract, inject, seq-*, bench) now answer as
    the reference does, stdout and ``-o`` file alike: the input graph
    stored after gaf, matrix, pangenotype and inject, the subgraph after
    extract, nothing after seq-* and bench (they load no graph); serve
    answers the first five and refuses bench, as the reference's."""
    from pollen_tpu_torch.synth import synth_gaf

    gfa = str(GRAPH_DIR / "tiny.gfa")
    bed = str(GOLDEN_DIR / "tiny.bed")
    gaf = tmp_path / "reads.gaf"
    gaf.write_bytes(synth_gaf(parse_gfa((GRAPH_DIR / "tiny.gfa")
                                        .read_bytes()), 30, seed=3))
    seq = tmp_path / "bases.txt"
    seq.write_text("ACGTTGCA\nAC\n")
    packed = tmp_path / "bases.packedseq"
    packed.write_bytes(bytes.fromhex(
        (GOLDEN_DIR / "tiny.packedseq.hex").read_text().strip()))
    for argv in (
        ["gaf", str(gaf)],
        ["matrix", str(gaf)],
        ["pangenotype", str(gaf)],
        ["extract", "-n", "1", "-c", "1"],
        ["inject", "--bed", bed],
        ["seq-export", str(seq), str(tmp_path / "{who}.ps")],
        ["seq-import", str(packed)],
        ["bench", "--wcl", gfa],
    ):
        outs = []
        for run, who in ((port_run, "port"), (ref_run, "ref")):
            out_file = tmp_path / f"{argv[0]}.{who}.flatgfa"
            line = [a.format(who=who) for a in argv]
            text = run(["-I", gfa, "-o", str(out_file), *line])
            stored = out_file.read_bytes() if out_file.exists() else None
            exported = tmp_path / f"{who}.ps"
            outs.append((text, stored, exported.exists()
                         and exported.read_bytes()))
        assert outs[0] == outs[1], argv
        assert outs[0][0] or argv[0] in ("extract", "seq-export"), argv
        assert (outs[0][1] is None) == (argv[0] in ("seq-export",
                                                    "seq-import", "bench"))
    requests = (f"inject --bed {bed}\ngaf {gaf}\nmatrix {gaf}\n"
                f"pangenotype {gaf}\nextract -n 1 -c 1\nbench\ndepth -d\n")
    text = port_run(["-I", gfa, "serve"], requests)
    assert text == ref_run(["-I", gfa, "serve"], requests)
    assert text.count("##end\tok\n") == 6
    assert "##end\terror\tcommand 'bench' is not served" in text
