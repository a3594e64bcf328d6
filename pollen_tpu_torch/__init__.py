"""pollen_tpu_torch: the PyTorch / CUDA port of pollen-tpu for the H100.

It sits beside the JAX package (``pollen_tpu``), which stays the
reference, and imports ``torch`` and never ``jax``. The jax-free host
code of the reference (GFA parsers, ``GraphArrays``, the binary format,
the CLI grammar) is shared as it is.

Modules, from the entry point down:

* :mod:`pollen_tpu_torch.cli` — ``fgfa-torch``: ``depth`` and ``serve``.
* :mod:`pollen_tpu_torch.ops.depth` — depth queries and the router.
* :mod:`pollen_tpu_torch.device` — ``TorchGraph`` and its ingest.
* :mod:`pollen_tpu_torch.kernels` — host packers, plain versions and the
  wrappers of the hand-written CUDA kernels in ``csrc/``.
* :mod:`pollen_tpu_torch.synth` — seeded synthetic graphs.
"""

__version__ = "0.1.0"

# The shared, jax-free arena and GFA parsers, as the reference package
# exports them at its top level.
from pollen_tpu.flatgfa import GraphArrays, parse_gfa, parse_gfa_file  # noqa: F401,E402
