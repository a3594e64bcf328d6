"""flash-torch: a shell-compatible DSL for graph pipelines.

The port of the JAX package's ``flash-tpu`` (pollen_tpu/shell).
Reference analogue: flatgfa-sh ("flash") — parse real shell syntax,
lower ``odgi``/``bedtools``/``gunzip`` invocations to a resource-typed
dataflow IR, optionally optimize (file-format strength reduction, pipe
elision, dedup), and evaluate with in-process engine calls plus real
subprocesses for unknown commands.
"""

from .ir import Instr, Program, Resource  # noqa: F401
from .parse import shell_to_ir  # noqa: F401
from .opt import optimize  # noqa: F401
from .evaluate import run_program  # noqa: F401
