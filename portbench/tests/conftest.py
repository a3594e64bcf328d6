"""The benchmark's own CPU tests (``python -m pytest portbench/tests``).
Tests that need the card carry the ``card`` marker and skip inside the
test where there is none."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Tiny stand-ins for the configurations, at sizes a CPU test holds: the
# configured haplotypes and bubble shapes over fewer sites (400 sites:
# 1,348 segments, 82,053 steps, two tandem-repeat loops).
TINY = {
    "hprc_chr8": dict(sites=400),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips inside the test without one)")


def tiny_config(name: str) -> dict:
    from portbench import registry

    cfg = registry.config(name)
    cfg.update(TINY[name])
    cfg["segments"], cfg["steps"] = registry.shape(cfg["shape"]).sizes(cfg)
    return cfg


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda")
