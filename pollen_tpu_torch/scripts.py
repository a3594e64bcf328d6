"""Locate — or synthesize — the port's console scripts.

The port's copy of the JAX package's pollen_tpu/scripts.py. The four
CLIs (``fgfa-torch``, ``flash-torch``, ``exine-torch``,
``pollen-spec-torch``) are declared as
entry points in pyproject.toml, but tests and scripts must work from a
bare checkout too (no ``pip install -e .``).
``script_env()`` returns an environment whose PATH resolves all four:
either they are already installed, or thin ``python -m`` shims are
written to ``<repo>/.bin`` and that directory is prepended.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import stat
import sys
from typing import Dict, Optional

# script name -> module runnable with `python -m`
SCRIPTS: Dict[str, str] = {
    "fgfa-torch": "pollen_tpu_torch",
    "flash-torch": "pollen_tpu_torch.shell",
    "exine-torch": "pollen_tpu_torch.accel",
    "pollen-spec-torch": "pollen_tpu_torch.spec",
}

_REPO = pathlib.Path(__file__).resolve().parent.parent


def _write_shim(bindir: pathlib.Path, name: str, module: str) -> None:
    shim = bindir / name
    body = (
        "#!/bin/sh\n"
        f'PYTHONPATH="{_REPO}${{PYTHONPATH:+:$PYTHONPATH}}" '
        f'exec "{sys.executable}" -m {module} "$@"\n'
    )
    if shim.exists() and shim.read_text() == body:
        return
    shim.write_text(body)
    shim.chmod(shim.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP)


def script_env(base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Environment (copy) in which all four console scripts resolve."""
    env = dict(os.environ if base is None else base)
    missing = [n for n in SCRIPTS if shutil.which(n, path=env.get("PATH"))
               is None]
    if not missing:
        return env
    bindir = _REPO / ".bin"
    bindir.mkdir(exist_ok=True)
    for name, module in SCRIPTS.items():
        _write_shim(bindir, name, module)
    env["PATH"] = f"{bindir}{os.pathsep}{env.get('PATH', '')}"
    return env
