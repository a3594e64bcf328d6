"""The port's graph writer against the JAX reference's, byte for byte:
``save_flatgfa`` (with spare capacity) and ``update_in_place``, the
preserved-order GFA emitter, and the CLI's ``-o``, ``-O`` and ``-m``
(one-shot and served), against ``pollen_tpu``'s writer, its CLI and
the committed ``tests/golden/tiny.flatgfa.hex``. Also the repaired
``_needs_masked_index``: ``depth -b`` builds no masked index.
"""

import pytest
import torch

from conftest import FIXTURE_GRAPHS, GOLDEN_DIR, GRAPH_DIR
from graphgen import random_graph
from pollen_tpu import emit as ref_emit
from pollen_tpu import fileformat as ref_fileformat
from pollen_tpu.bed import parse_bed_file as ref_parse_bed_file
from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import parse_gfa as ref_parse_gfa
from pollen_tpu.ops.window_depth import run_bed_depth as ref_run_bed_depth
from pollen_tpu_torch import cli as port_cli
from pollen_tpu_torch import emit as port_emit
from pollen_tpu_torch import fileformat as port_fileformat
from pollen_tpu_torch.flatgfa import parse_gfa
from test_torch_ops import port_run, ref_run

torch.set_num_threads(1)

# The graph of tests/golden/tiny.flatgfa.hex (tests/test_golden_binary.py).
HEX_GFA = b"S\t1\tAC\nS\t2\tG\nP\tp\t1+,2-\t*\nL\t1\t+\t2\t+\t2M\n"
CASES = FIXTURE_GRAPHS + ["gen_rand_olap"]


def gfa_bytes(name: str) -> bytes:
    if name == "gen_rand_olap":
        return random_graph(
            n_segs=40, n_paths=5, seed=5, with_overlap_col=True
        ).encode()
    return (GRAPH_DIR / name).read_bytes()


def test_save_flatgfa_matches_the_hex_golden(tmp_path):
    path = tmp_path / "tiny.flatgfa"
    port_fileformat.save_flatgfa(str(path), parse_gfa(HEX_GFA))
    want = bytes.fromhex((GOLDEN_DIR / "tiny.flatgfa.hex").read_text().strip())
    assert path.read_bytes() == want


@pytest.mark.parametrize("spare", [0.0, 0.5, 2.0])
@pytest.mark.parametrize("case", CASES)
def test_save_flatgfa_matches_reference(case, spare, tmp_path):
    data = gfa_bytes(case)
    ref_file, port_file = tmp_path / "ref.flatgfa", tmp_path / "port.flatgfa"
    ref_fileformat.save_flatgfa(str(ref_file), ref_parse_gfa(data), spare=spare)
    port_fileformat.save_flatgfa(str(port_file), parse_gfa(data), spare=spare)
    assert port_file.read_bytes() == ref_file.read_bytes()
    # The port reads back what it wrote.
    back = port_fileformat.load_flatgfa(str(port_file))
    assert port_emit.emit_gfa(back) == data.decode()


@pytest.mark.parametrize("order", ["preserved", "normalized", "sorted"])
@pytest.mark.parametrize("case", CASES)
def test_emit_gfa_matches_reference(case, order):
    data = gfa_bytes(case)
    assert port_emit.emit_gfa(parse_gfa(data), order=order) == ref_emit.emit_gfa(
        ref_parse_gfa(data), order=order
    )


def test_emit_gfa_of_paths_without_steps():
    data = b"S\t1\tA\nP\tx\t\t*\nP\ty\t\t*\n"
    assert port_emit.emit_gfa(parse_gfa(data)) == data.decode()


def test_update_in_place_matches_reference(tmp_path):
    """A crushed graph written back into a file with spare room: the
    same bytes as the reference's rewrite; a pool past its capacity is
    refused by both."""
    from pollen_tpu.ops.transform import chop as ref_chop, crush as ref_crush
    from pollen_tpu_torch.ops.transform import chop, crush

    data = (GRAPH_DIR / "nruns.gfa").read_bytes()
    ref_file, port_file = tmp_path / "ref.flatgfa", tmp_path / "port.flatgfa"
    for f, save in ((ref_file, ref_fileformat), (port_file, port_fileformat)):
        save.save_flatgfa(str(f), (ref_parse_gfa if save is ref_fileformat
                                   else parse_gfa)(data), spare=0.5)
    ref_fileformat.update_in_place(str(ref_file), ref_crush(ref_parse_gfa(data)))
    port_fileformat.update_in_place(str(port_file), crush(parse_gfa(data)))
    assert port_file.read_bytes() == ref_file.read_bytes()
    with pytest.raises(ref_fileformat.FlatFileError):
        ref_fileformat.update_in_place(str(ref_file), ref_chop(ref_parse_gfa(data), 1))
    with pytest.raises(port_fileformat.FlatFileError):
        port_fileformat.update_in_place(str(port_file), chop(parse_gfa(data), 1))
    assert port_file.read_bytes() == ref_file.read_bytes()


def write_both(tmp_path, argv_of):
    """Run both CLIs with ``argv_of(out_path)``; (port bytes, reference
    bytes, port stdout, reference stdout)."""
    ref_out, port_out = tmp_path / "ref.out", tmp_path / "port.out"
    ref_text = ref_run(argv_of(ref_out))
    port_text = port_run(argv_of(port_out))
    return port_out.read_bytes(), ref_out.read_bytes(), port_text, ref_text


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("prealloc", ["0", "0.5"])
def test_conversion_matches_reference(case, prealloc, tmp_path):
    """``-I x.gfa -o y.flatgfa`` (the reference's native converter
    where it is built) and ``-I x.gfa -O y.gfa`` (the input again)."""
    src = tmp_path / "in.gfa"
    src.write_bytes(gfa_bytes(case))
    got, want, _, _ = write_both(
        tmp_path, lambda out: ["-I", str(src), "-p", prealloc, "-o", str(out)]
    )
    assert got == want
    got, want, _, _ = write_both(
        tmp_path, lambda out: ["-I", str(src), "-O", str(out)]
    )
    assert got == want == src.read_bytes()


def test_conversion_of_the_hex_golden_graph(tmp_path):
    src = tmp_path / "tiny.gfa"
    src.write_bytes(HEX_GFA)
    out = tmp_path / "tiny.flatgfa"
    port_run(["-I", str(src), "-o", str(out)])
    want = bytes.fromhex((GOLDEN_DIR / "tiny.flatgfa.hex").read_text().strip())
    assert out.read_bytes() == want
    # Read back with -i: the GFA again, and the same table of contents.
    assert port_run(["-i", str(out)]) == HEX_GFA.decode()
    for argv in (["toc"], ["toc", "-b"], ["paths"], ["stats"]):
        assert port_run(["-i", str(out), *argv]) == ref_run(
            ["-i", str(out), *argv]
        ), argv


@pytest.mark.parametrize(
    "command",
    [["degree"], ["validate"], ["flip"], ["norm"], ["depth", "-d"]],
    ids=lambda c: "_".join(c),
)
def test_output_after_a_command_matches_reference(command, tmp_path):
    gfa = str(GRAPH_DIR / "rev.gfa")
    for flag in ("-o", "-O"):
        got, want, port_text, ref_text = write_both(
            tmp_path, lambda out: ["-I", gfa, flag, str(out), *command]
        )
        assert got == want and port_text == ref_text


@pytest.mark.parametrize(
    "command", [["crush"], ["chop", "-c", "3"], ["flip"]],
    ids=lambda c: c[0],
)
def test_mutate_in_place_matches_reference(command, tmp_path):
    """``-i file -m <transform>`` rewrites the file in place and prints
    nothing, as the reference does."""
    data = (GRAPH_DIR / "nruns.gfa").read_bytes()
    files = {}
    for who, save, parse in (("ref", ref_fileformat, ref_parse_gfa),
                             ("port", port_fileformat, parse_gfa)):
        files[who] = tmp_path / f"{who}.flatgfa"
        save.save_flatgfa(str(files[who]), parse(data), spare=4.0)
    ref_text = ref_run(["-i", str(files["ref"]), "-m", *command])
    port_text = port_run(["-i", str(files["port"]), "-m", *command])
    assert port_text == ref_text == ""
    assert files["port"].read_bytes() == files["ref"].read_bytes()
    # Without -i, -m is ignored and the transform is printed.
    gfa = str(GRAPH_DIR / "nruns.gfa")
    assert port_run(["-I", gfa, "-m", *command]) == ref_run(
        ["-I", gfa, "-m", *command]
    )


def test_depth_bed_builds_no_masked_index(monkeypatch, tmp_path):
    """``depth -b X -S Y`` (and ``-d -s`` beside ``-b``) answers from
    the bed route alone, so it builds no crossing matrix or ELL index
    (``cross_matrix="never"``); the answer is the reference's
    ``run_bed_depth``."""
    stem = "rand1"
    gfa = str(GRAPH_DIR / f"{stem}.gfa")
    bed = str(GOLDEN_DIR / f"{stem}.bed")
    batch = tmp_path / "batch.txt"
    batch.write_text((GOLDEN_DIR / f"{stem}.paths").read_text())
    built = []
    real = port_cli.build_graph

    def spy(g, device, **kw):
        built.append(kw.get("cross_matrix"))
        return real(g, device, **kw)

    monkeypatch.setattr(port_cli, "build_graph", spy)
    g_ref = ref_parse_gfa((GRAPH_DIR / f"{stem}.gfa").read_bytes())
    want = ref_run_bed_depth(
        g_ref, build_device_graph(g_ref), ref_parse_bed_file(bed)
    )
    for argv in (
        ["depth", "-b", bed, "-S", str(batch)],
        ["depth", "-d", "-b", bed, "-s", str(GOLDEN_DIR / f"{stem}.depthpaths")],
        ["bed-depth", "-b", bed],
    ):
        assert port_run(["-I", gfa, *argv]) == want, argv
        assert built[-1] == "never", argv
        args = port_cli.build_parser().parse_args(["-I", gfa, *argv])
        assert not port_cli._needs_masked_index(args)
    assert want and len(built) == 3
    # Without -b, -S still builds the masked indexes.
    port_run(["-I", gfa, "depth", "-S", str(batch)])
    assert built[-1] == "auto"
