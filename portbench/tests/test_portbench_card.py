"""The command line: without a card it prints no result and exits
non-zero; on the card (marked ``card``) a short run of a cell is
correct."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _cli(*args, timeout=900):
    return subprocess.run([sys.executable, "-m", "portbench", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _cli("--workload", "hprc_chr8.single", "--seed", "1",
               "--seconds", "1", "--trace", "0", timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.card
@pytest.mark.parametrize("trace", ["0", "1"])
def test_short_run_on_card(card, trace):
    out = _cli("--workload", "hprc_chr8.single", "--seed", str(2**31 + 5),
               "--seconds", "2", "--trace", trace)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
