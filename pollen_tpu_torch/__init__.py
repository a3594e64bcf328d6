"""pollen_tpu_torch: the PyTorch / CUDA port of pollen-tpu for the H100.

It sits beside the JAX package (``pollen_tpu``), which stays the
reference, imports ``torch`` and never ``jax``, and imports nothing of
``pollen_tpu``: the arena and its GFA parser (:mod:`.flatgfa`), the
binary file format (:mod:`.fileformat`), the emitter (:mod:`.emit`),
the BED reader (:mod:`.bed`), the packed sequences (:mod:`.packedseq`)
and the CLI grammars are the port's own copies.

Modules, from the entry point down:

* :mod:`pollen_tpu_torch.api` — the object API (``FlatGFA``,
  ``parse``, ``parse_bytes``, ``load``; ``device`` selects where the
  index is built).
* :mod:`pollen_tpu_torch.shell` — ``flash-torch``: the shell DSL, its
  IR, optimizer and evaluator.
* :mod:`pollen_tpu_torch.cli` — ``fgfa-torch``: every command of
  ``fgfa-tpu``, ``-o``/``-O``/``-m``, and ``serve``.
* :mod:`pollen_tpu_torch.accel` — ``exine-torch``: the fixed-dimension
  depth accelerator (its PE array plain torch on the device).
* :mod:`pollen_tpu_torch.ops.depth` — depth queries and the router.
* :mod:`pollen_tpu_torch.ops` ``degree``, ``flatten``, ``validate``,
  ``position``, ``overlap``, ``transform``, ``window_depth``,
  ``matrix``, ``gaf``, ``extract``, ``inject``, ``bench`` — the other
  graph commands (plain torch on the device, numpy on the host).
* :mod:`pollen_tpu_torch.device` — ``TorchGraph`` and its ingest.
* :mod:`pollen_tpu_torch.kernels` — host packers, plain versions and the
  wrappers of the hand-written CUDA kernels in ``csrc/``.
* :mod:`pollen_tpu_torch.flatgfa`, :mod:`pollen_tpu_torch.fileformat`,
  :mod:`pollen_tpu_torch.emit`, :mod:`pollen_tpu_torch.bed` — the arena,
  the GFA parser, the binary loader and writer, the GFA emitter and the
  BED reader; :mod:`pollen_tpu_torch.packedseq` — packed nucleotide
  files (``seq-export``, ``seq-import``).
* :mod:`pollen_tpu_torch.native` — the C++ GFA scanner, emitter,
  converter and C API (built with ``g++`` at first use; NumPy fallback);
  :mod:`pollen_tpu_torch.spec` — the executable spec
  (``pollen-spec-torch``), the oracle the port is held to.
* :mod:`pollen_tpu_torch.synth` — seeded synthetic graphs;
  :mod:`pollen_tpu_torch.profiling` — wall-time logging, torch.profiler
  traces and a synchronized best-of timer; :mod:`pollen_tpu_torch.entry`
  — the masked-depth forward on a tiny graph;
  :mod:`pollen_tpu_torch.scripts` — the console scripts from a bare
  checkout.
"""

__version__ = "0.1.0"

# The object API, the arena and the GFA parser, as the reference package
# exports them at its top level. None of these imports torch: spawned
# GAF parse workers import this package.
from .api import FlatGFA, load, parse, parse_bytes  # noqa: F401,E402
from .flatgfa import GraphArrays, parse_gfa, parse_gfa_file  # noqa: F401,E402
