"""The port's examples (examples/torch/) print, byte for byte, what their
counterparts in examples/ print on the same inputs, and pass the
assertions tests/test_examples.py makes of those.

The Python examples run in this process (``runpy`` with ``sys.argv``
set, stdout captured): the JAX package's under the tests' CPU platform,
the port's with ``--device cpu``. The two shell scripts and the flash
scripts run as subprocesses of the console scripts (``script_env``),
each with a timeout. The reference's windows.sh writes and removes
``tiny.w4.bed`` in its working directory, so it runs here from a
temporary directory that links the fixtures, never from the repository
root, where tests/test_examples.py runs it.
"""

import contextlib
import io
import pathlib
import runpy
import subprocess
import sys

import pytest
import torch

from pollen_tpu.scripts import script_env as ref_script_env
from pollen_tpu_torch.device import build_graph
from pollen_tpu_torch.flatgfa import parse_gfa_file
from pollen_tpu_torch.ops.depth import run_seg_depth
from pollen_tpu_torch.scripts import script_env

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
PORT = EXAMPLES / "torch"
GFA = EXAMPLES / "example.gfa"
DEPTH_LINES = ["1\t2", "2\t2", "3\t1", "4\t2"]


def run_in_process(monkeypatch, path, argv, stdin=None) -> str:
    out = io.StringIO()
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [str(path)] + argv)
        if stdin is not None:
            m.setattr(sys, "stdin", io.StringIO(stdin))
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(path), run_name="__main__")
    return out.getvalue()


def run_script(argv, cwd=REPO, **extra_env) -> str:
    env = dict(script_env(ref_script_env()), **extra_env)
    r = subprocess.run(argv, capture_output=True, text=True, timeout=300,
                       cwd=str(cwd), env=env, stdin=subprocess.DEVNULL)
    assert r.returncode == 0, r.stderr
    return r.stdout


def check_depth(out):
    lines = out.splitlines()
    assert lines[0] == "#node.id\tdepth"
    assert lines[1:] == DEPTH_LINES


def check_spec_depth(out):
    assert out.splitlines()[1:] == DEPTH_LINES


def check_gaf(out):
    lines = out.splitlines()
    assert lines[0] == "foo"
    assert lines[1] == "AAGAAATTTTCT"
    assert "(5, 8)" in out and "bar" in out


def check_matrix(out):
    assert out.startswith("example.gaf 1 1 1 1")


def check_flash(out):
    assert "#node.id\tdepth\tdepth.uniq" in out
    assert "#path\tstart\tend\tmean.depth" in out
    assert out.index("#node.id") < out.index("#path")


def check_windows(out):
    assert out.splitlines()[0].startswith("alpha\t0\t4\t")


def check_batch_depth(out):
    assert out.count("# subset") == 3
    # Subset 1 is all paths: its block is the plain depth -d table.
    g = parse_gfa_file(str(GFA))
    single = run_seg_depth(g, build_graph(g, "cpu"))
    block = out.split("# subset ")[2].splitlines()[1:]
    assert "\n".join(block) + "\n" == single


CHECKS = {
    "depth": check_depth,
    "batch_depth": check_batch_depth,
    "gaf": check_gaf,
    "matrix": check_matrix,
    "spec_depth": check_spec_depth,
    "flash_example": check_flash,
    "windows": check_windows,
}
# The Python examples that take --device (spec_depth needs no device).
DEVICE_EXAMPLES = ("depth", "batch_depth", "gaf", "matrix")


def outputs(name, monkeypatch, tmp_path):
    """(reference stdout, port stdout) of one example pair."""
    if name == "flash_example":
        return (
            run_script(["flash-tpu", str(EXAMPLES / "flash_example.sh")]),
            run_script(["flash-torch", "--device", "cpu",
                        str(PORT / "flash_example.sh")]),
        )
    if name == "windows":
        ref_dir, port_tmp = tmp_path / "ref", tmp_path / "port_tmp"
        ref_dir.mkdir()
        port_tmp.mkdir()
        (ref_dir / "tests").symlink_to(REPO / "tests")
        ref = run_script(["sh", str(EXAMPLES / "windows.sh")], cwd=ref_dir)
        port = run_script(["sh", str(PORT / "windows.sh"), "cpu"],
                          TMPDIR=str(port_tmp))
        # The port's BED windows lived in a temporary file, now removed.
        assert not list(port_tmp.iterdir())
        return ref, port
    stdin = GFA.read_text() if name == "spec_depth" else None
    port_argv = [] if name == "spec_depth" else ["--device", "cpu"]
    return (
        run_in_process(monkeypatch, EXAMPLES / f"{name}.py", [], stdin),
        run_in_process(monkeypatch, PORT / f"{name}.py", port_argv, stdin),
    )


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_port_example_prints_the_reference_bytes(name, monkeypatch, tmp_path):
    ref, port = outputs(name, monkeypatch, tmp_path)
    assert port == ref
    CHECKS[name](port)


@pytest.mark.parametrize("name", DEVICE_EXAMPLES)
def test_port_example_refuses_cuda_without_a_card(name, monkeypatch):
    """``--device cuda`` (and the default) with no card raises, never a
    quiet run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--device", "cuda"], []):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_in_process(monkeypatch, PORT / f"{name}.py", argv)


@pytest.mark.parametrize("flags", [[], ["--nl"]], ids=["links", "nl"])
def test_model_emitter_cli(flags):
    """``python -m pollen_tpu_torch.spec.model [--nl]`` emits what the
    reference's ``python -m pollen_tpu.spec.model`` emits."""
    gfa = GFA.read_text()
    outs = []
    for module in ("pollen_tpu.spec.model", "pollen_tpu_torch.spec.model"):
        r = subprocess.run([sys.executable, "-m", module] + flags, input=gfa,
                           capture_output=True, text=True, timeout=300,
                           cwd=str(REPO), env=script_env())
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout)
    assert outs[1] == outs[0]
    assert outs[1].count("L\t") == (0 if flags else 4)
