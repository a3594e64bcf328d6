"""The port's multi-rank dry run (the counterpart of
``__graft_entry__.dryrun_multichip``) as one 8-rank gloo job on the CPU,
under the launcher's deadline: every check of the dry run passes on
every rank, the CLI form exits 0, and no rank loads JAX or anything of
the reference."""

import subprocess
import sys

import torch

from conftest import REPO
from pollen_tpu_torch.parallel import dryrun

torch.set_num_threads(1)

DEADLINE = 240  # seconds; the run takes about 10


def test_dryrun_multichip_cpu():
    results = dryrun.dryrun_multichip(8, device="cpu", deadline=DEADLINE)
    assert len(results) == 8
    for r in results:
        assert r["mesh"] == {"host": 2, "chip": 4}
        assert r["depth"] == [2, 3, 1, 1] and r["degree"] == [1, 3, 1, 1]
        assert all(c > 0 for c in r["classes"]) and r["straddles"] > 0
        assert r["foreign_modules"] == []


def test_dryrun_cli_cpu():
    """``python -m pollen_tpu_torch.parallel.dryrun 2 --device cpu``: the
    default mesh of two host rows of one chip; and the refusal of a
    single rank (no chunk bound for a group to straddle)."""
    dryrun_cli = [sys.executable, "-m", "pollen_tpu_torch.parallel.dryrun"]
    proc = subprocess.run(
        [*dryrun_cli, "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=DEADLINE,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dryrun_multichip OK on 2 ranks (cpu, mesh {'host': 2, 'chip': 1})" in proc.stdout
    one = subprocess.run(
        [*dryrun_cli, "1", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=DEADLINE,
    )
    assert one.returncode != 0 and "needs 2 ranks or more" in one.stderr
