"""Executable specification layer: clarity-first GFA model + commands.

The port's own copy of the JAX package's spec (pollen_tpu/spec), which
imports nothing of that package: the oracle for the fast engine
(reference project analogue: mygfa + slow_odgi).
"""

from . import commands  # noqa: F401
from .model import (  # noqa: F401
    Bed,
    Cigar,
    Graph,
    Handle,
    Link,
    Path,
    Segment,
    adjacency,
    graph_maxes,
    path_sequences,
    revcomp,
    step_index,
)
