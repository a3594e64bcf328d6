"""Fixed-dimension depth accelerator: a port of pollen_tpu/accel/
(reference analogue: pollen_py's Calyx generator + pollen_data_gen).

The reference's L7 emits hardware — one processing element per graph
node over fixed-size memories — and simulates it. The port keeps the
same *contract* (static dimensions max_nodes / max_steps / max_paths,
JSON-serialized memories, odgi-style TSV out); the PE array is plain
torch on the chosen device, every node's PE one row of a batched
computation.
"""

from .datagen import depth_json, graph_json, parse_depth_json  # noqa: F401
from .kernel import node_depth_accel  # noqa: F401
