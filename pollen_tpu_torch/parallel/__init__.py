"""Multi-rank execution: meshes, step-sharded graph pieces, collective
reductions over ``torch.distributed`` (a port of pollen_tpu/parallel/,
the reference's scaling story, SURVEY.md §5/§7).

* ``sharded.py``: the ``(host, chip)`` DeviceMesh, the step-sharded scan
  family (the fused form on K6 with a device look-back carry), degree,
  and the column-sharded crossing matrix (K2) and tiered ELL (K9, K2;
  batched: K5) with no collective;
* ``loader.py``: byte-range GFA parsing and the blob codecs;
* ``distributed.py``: process-group set-up and the rank-sharded ingest;
* ``collectives.py``: the collectives, host-staged under gloo;
* ``launch.py``: spawn n ranks with a file rendezvous and a deadline;
* ``dryrun.py``: ``python -m pollen_tpu_torch.parallel.dryrun N``.
"""

from .sharded import (  # noqa: F401
    ShardedGraph,
    make_mesh,
    shard_device_graph,
    sharded_seg_depth_fn,
)
