"""pollen_tpu_torch: the PyTorch / CUDA port of pollen-tpu for the H100.

It sits beside the JAX package (``pollen_tpu``), which stays the
reference, imports ``torch`` and never ``jax``, and imports nothing of
``pollen_tpu``: the arena and its GFA parser (:mod:`.flatgfa`), the
binary loader (:mod:`.fileformat`) and the CLI grammar are the port's
own copies.

Modules, from the entry point down:

* :mod:`pollen_tpu_torch.cli` — ``fgfa-torch``: ``depth`` and ``serve``.
* :mod:`pollen_tpu_torch.ops.depth` — depth queries and the router.
* :mod:`pollen_tpu_torch.device` — ``TorchGraph`` and its ingest.
* :mod:`pollen_tpu_torch.kernels` — host packers, plain versions and the
  wrappers of the hand-written CUDA kernels in ``csrc/``.
* :mod:`pollen_tpu_torch.flatgfa`, :mod:`pollen_tpu_torch.fileformat` —
  the arena, the GFA parser and the binary loader.
* :mod:`pollen_tpu_torch.synth` — seeded synthetic graphs.
"""

__version__ = "0.1.0"

# The arena and the GFA parser, as the reference package exports them at
# its top level.
from .flatgfa import GraphArrays, parse_gfa, parse_gfa_file  # noqa: F401,E402
