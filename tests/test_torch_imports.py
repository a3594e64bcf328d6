"""The port never imports JAX: every module of ``pollen_tpu_torch`` and
a CLI run load in a fresh interpreter with ``jax`` absent from
``sys.modules`` (the machine with the card has no JAX installed)."""

import pathlib
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import contextlib, io, pkgutil, importlib, sys
import pollen_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    pollen_tpu_torch.__path__, "pollen_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from pollen_tpu_torch import cli
out = io.StringIO()
cli.main(["--device", "cpu", "-I", sys.argv[1], "depth", "-d", "-s",
          sys.argv[2]], stdout=out)
assert out.getvalue() == open(sys.argv[3]).read()
assert "jax" not in sys.modules, sorted(
    m for m in sys.modules if m.split(".")[0] == "jax")
assert not any(m.startswith("pollen_tpu.") and m.split(".")[1] in
               ("device", "ops", "kernels", "parallel") for m in sys.modules)
print(len(names))
"""


def test_port_imports_no_jax():
    golden = REPO / "tests" / "golden"
    proc = subprocess.run(
        [
            sys.executable,
            "-c",
            SCRIPT,
            str(REPO / "tests" / "graphs" / "tiny.gfa"),
            str(golden / "tiny.depthpaths"),
            str(golden / "tiny.depth_subset"),
        ],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    # __main__, cli, device, synth, kernels (+4), ops (+1)
    assert int(proc.stdout.strip()) >= 10
