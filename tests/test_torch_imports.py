"""The port imports neither JAX nor anything of the JAX package: every
module of ``pollen_tpu_torch`` (the object API, the shell, the console
scripts, profiling and the entry among them), CLI runs (depth, degree,
flip with ``-O``, ``gaf -b``, ``extract`` and ``exine-torch depth -a
-r``), the API (``parse``, ``device()``, ``all_reads``), a
``flash-torch`` program, profiling, ``entry``, the native scanner,
emitter and converter, the spec and the two ELL and transform probes
load in a fresh interpreter
with ``jax`` and every ``pollen_tpu`` module absent from
``sys.modules`` (the machine with the card has no JAX installed), and
no import statement of the port or of ``chip_smoke.py`` names them, nor
the reference's ``bench`` or ``probes`` scripts."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, io, pkgutil, sys
sys.path.insert(0, ".")
import chip_smoke
import pollen_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    pollen_tpu_torch.__path__, "pollen_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("api", "entry", "profiling", "scripts", "shell",
             "shell.__main__", "shell.evaluate", "shell.ir", "shell.opt",
             "shell.parse", "native", "spec", "spec.__main__",
             "spec.commands", "spec.model", "probes.ell_probe",
             "probes.transform_probe"):
    assert "pollen_tpu_torch." + name in names, name
from pollen_tpu_torch import cli
for argv, golden in (
    (["depth", "-d", "-s", sys.argv[2]], sys.argv[3]),
    (["depth", "-d"], sys.argv[4]),
    (["degree"], sys.argv[5]),
    (["-O", sys.argv[6], "flip"], sys.argv[7]),
):
    out = io.StringIO()
    cli.main(["--device", "cpu", "-I", sys.argv[1], *argv], stdout=out)
    assert out.getvalue() == open(golden).read(), argv
assert open(sys.argv[6]).read() == open(sys.argv[1]).read()
for argv in (["-I", "examples/example.gfa", "gaf", "-b",
              "examples/example.gaf"], ["-I", sys.argv[1], "extract", "-n",
                                        "1", "-c", "1"]):
    out = io.StringIO()
    cli.main(["--device", "cpu", *argv], stdout=out)
    assert out.getvalue(), argv
import contextlib
from pollen_tpu_torch.accel.__main__ import main as exine
out = io.StringIO()
with contextlib.redirect_stdout(out):
    exine(["--device", "cpu", "depth", "-a", "-r", sys.argv[1]])
assert out.getvalue() == open(sys.argv[4]).read()
import tempfile
g = pollen_tpu_torch.parse("examples/example.gfa", device="cpu")
assert g.device().device.type == "cpu"
assert len(list(g.all_reads("examples/example.gaf"))) > 0
from pollen_tpu_torch.shell import optimize, run_program, shell_to_ir
prog = optimize(shell_to_ir("odgi depth -i " + sys.argv[1] + " -d"))
assert run_program(prog, device="cpu").decode() == open(sys.argv[4]).read()
from pollen_tpu_torch import profiling
from pollen_tpu_torch.entry import entry
from pollen_tpu_torch.scripts import script_env
forward, args = entry("cpu")
with tempfile.TemporaryDirectory() as tmp, profiling.device_trace(tmp):
    with profiling.stopwatch("entry"):
        assert forward(*args)[0].tolist() == [2, 3, 1, 1]
assert profiling.time_best(forward, *args, reps=1) >= 0
import shutil
assert shutil.which("flash-torch", path=script_env()["PATH"])
import torch
from pollen_tpu_torch import native
from pollen_tpu_torch.emit import emit_gfa
from pollen_tpu_torch.flatgfa import parse_gfa
data = open(sys.argv[1], "rb").read()
if shutil.which("g++"):
    assert native.native_available(), native.build_error
    assert native.emit_gfa_native(native.parse_gfa_native(data)) == data.decode()
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        cli.main(["--device", "cpu", "-I", sys.argv[1], "-o", tmp + "/t.fgfa"],
                 stdout=out)
        assert native.convert_gfa_native(data, tmp + "/n.fgfa")
        assert open(tmp + "/t.fgfa", "rb").read() == open(tmp + "/n.fgfa",
                                                          "rb").read()
assert emit_gfa(parse_gfa(data)).encode() == data
from pollen_tpu_torch.spec import commands as spec_commands
from pollen_tpu_torch.spec.model import Graph
spec_out = io.StringIO()
spec_commands.depth(Graph.parse_file(sys.argv[1]), spec_out)
assert spec_out.getvalue() == open(sys.argv[4]).read()
from pollen_tpu_torch.probes import ell_probe, transform_probe
cpu = torch.device("cpu")
g, dg = ell_probe.build((3000, 512, 8), cpu)
for stage in ("ellok", "ellbok", "ellp16ok"):
    assert ell_probe.run_stage(stage, None, dg, 3000, say=len)["diff"] == 0
assert transform_probe.stage_chop(g, cpu, say=len)["equal"]
assert transform_probe.stage_crush(g, cpu, say=len)["equal"]
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "pollen_tpu", "bench",
                                       "probes"))
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_nothing_of_jax_or_pollen_tpu(tmp_path):
    golden = REPO / "tests" / "golden"
    proc = subprocess.run(
        [
            sys.executable,
            "-c",
            SCRIPT,
            str(REPO / "tests" / "graphs" / "tiny.gfa"),
            str(golden / "tiny.depthpaths"),
            str(golden / "tiny.depth_subset"),
            str(golden / "tiny.depth"),
            str(golden / "tiny.degree"),
            str(tmp_path / "tiny.out.gfa"),
            str(golden / "tiny.flip"),
        ],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    # __main__, accel (+4), api, bed, cli, device, emit, entry,
    # fileformat, flatgfa, native, packedseq, profiling, scripts, synth,
    # kernels (+8), ops (+13), probes (+9), shell (+6), spec (+4)
    assert int(proc.stdout.strip()) >= 57


SOURCES = sorted((REPO / "pollen_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
] + sorted((REPO / "examples" / "torch").glob("*.py"))


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(REPO)) for p in SOURCES]
)
def test_no_import_statement_names_jax_or_pollen_tpu(path):
    """Imports inside functions count too (they run only on the card)."""
    banned = ("jax", "jaxlib", "pollen_tpu", "bench", "probes")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in banned, (
                f"{path.name}:{node.lineno} imports {mod}"
            )
