"""Multi-host orchestration: process-group set-up and rank-sharded ingest.

A port of pollen_tpu/parallel/distributed.py to ``torch.distributed``.
The execution model (SURVEY.md §5):

1. ``dist.init_process_group`` connects the ranks (:func:`initialize`).
2. Every rank computes the same newline-aligned byte ranges from the
   GFA's *size* (size-only seeks: no rank reads the whole file) and
   parses only its own range into range-local pools
   (``loader.parse_range_file``): O(file / ranks) parse work each.
3. One small exchange shares the per-range segment-name tables; every
   rank resolves its own links/steps against the global name index
   (O(local)), then a second exchange shares the resolved pools: the
   ranks never exchange or re-parse raw GFA text.
4. Each rank assembles the same arena by array concatenation
   (``flatgfa.merge_resolved``), builds the graph on its device and
   keeps its chunk of the sorted step index (sharded.py).

The exchanges are padded uint8 all-gathers (sizes, then bytes), with
no pickle. A world of one rank reduces to :func:`loader.load_gfa_sharded`.
"""

from __future__ import annotations

import datetime
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import build_graph
from ..flatgfa import GraphArrays, NameIndex
from . import loader
from .collectives import all_gather
from .sharded import ShardedGraph, make_mesh, shard_device_graph

# How long a rank waits in one collective before its process group
# gives up (a rank that died would otherwise leave the rest waiting).
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def default_backend(world_size: int, device: str = "cuda") -> str:
    """NCCL when the ranks run on cards and every rank has one of its
    own (NCCL refuses two ranks on one device), else gloo."""
    on_cards = torch.device(device).type == "cuda" and torch.cuda.is_available()
    if on_cards and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Connect this process to the job (``init_method`` such as
    ``tcp://host:port`` or ``file:///shared/path``). A world of one rank
    gets a process group too: the mesh needs one. A collective waits at
    most :data:`COLLECTIVE_TIMEOUT`. No-op without a world size."""
    if world_size is None:
        return
    dist.init_process_group(
        backend or default_backend(world_size),
        init_method=init_method,
        world_size=world_size,
        rank=rank,
        timeout=COLLECTIVE_TIMEOUT,
    )


def _exchange_device() -> torch.device:
    """Where the exchange's tensors live: the rank's card under NCCL,
    the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def exchange_blobs(blob: bytes, n_proc: int) -> List[bytes]:
    """All-gather one byte blob per rank: the sizes, then the blobs
    padded to the largest, as uint8 tensors."""
    device = _exchange_device()
    arr = torch.from_numpy(np.frombuffer(blob, np.uint8).copy()).to(device)
    sizes = all_gather(torch.tensor([arr.shape[0]], dtype=torch.int64, device=device))
    sizes = sizes.reshape(-1).cpu().tolist()
    padded = torch.zeros(max(max(sizes), 1), dtype=torch.uint8, device=device)
    padded[: arr.shape[0]] = arr
    all_blobs = all_gather(padded).cpu().numpy()
    return [all_blobs[i, : sizes[i]].tobytes() for i in range(n_proc)]


def ingest_arena(filename: str) -> GraphArrays:
    """Rank-sharded phase-1/2 load: returns the merged GraphArrays
    (identical on every rank; each rank parsed only its own range)."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0

    if n_proc == 1:
        return loader.load_gfa_sharded(filename, max(1, torch.cuda.device_count()))

    ranges = loader.split_ranges_file(filename, n_proc)
    mine = loader.parse_range_file(filename, *ranges[pid])

    # Exchange 1: segment-name tables (small: the resolution input).
    name_blobs = exchange_blobs(mine.seg_name.tobytes(), n_proc)
    all_names = np.concatenate([np.frombuffer(b, np.int64) for b in name_blobs])
    names = NameIndex(all_names)
    resolved = loader.resolve_deferred(mine, names)

    # Exchange 2: resolved pools (binary arrays, not GFA text).
    pool_blobs = exchange_blobs(loader.resolved_to_blob(resolved), n_proc)
    pieces = [loader.resolved_from_blob(b) for b in pool_blobs]
    return loader.merge_resolved(pieces)


def ingest(filename: str, mesh=None, device="cuda") -> ShardedGraph:
    """Load a GFA across the job and lay it out on the mesh.

    Each rank parses its own byte range; pools are exchanged so every
    rank holds the same arena, builds the graph on ``device`` (its own
    card by default) and keeps its chunk of the step index."""
    arena = ingest_arena(filename)
    mesh = mesh or make_mesh()
    dg = build_graph(arena, device)
    return shard_device_graph(dg, mesh)
