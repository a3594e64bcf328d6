"""Start the ranks of a ``torch.distributed`` job on this machine.

The reference runs its mesh on virtual devices inside one process;
torch has no such devices, so the dry run (dryrun.py) and the tests
start one process a rank. Each rank:

* is started by spawn (a fresh interpreter that imports only what the
  target's module imports, never a fork of the caller's state);
* joins a ``file://`` rendezvous in a temporary directory, so that jobs
  started side by side never race for a TCP port;
* takes ``cuda:rank % cards`` on the card, and NCCL when every rank
  has a card of its own, gloo otherwise (and always on the CPU);
* waits at most ``distributed.COLLECTIVE_TIMEOUT`` in one collective.

The parent joins the ranks with a deadline and kills every rank when it
passes or as soon as one rank fails, so a rank stuck in a collective
never outlives its job. On the card the parent builds the kernels
first, so that the ranks load one library instead of each building it.

    results = run(fn, n, *args, device="cpu", deadline=300)

calls ``fn(rank, world, device, *args)`` in every rank (``fn`` must be
a module-level function) and returns the ranks' results in rank order.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import distributed


def rank_device(rank: int, device: str) -> torch.device:
    """The device of ``rank``: ``cuda:rank % cards`` or the CPU."""
    if torch.device(device).type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def init_rank(rank: int, world: int, rendezvous: str, device: str) -> torch.device:
    """Set this rank's device and join the job through the file
    ``rendezvous`` (backend: ``distributed.default_backend``); returns
    the rank's device."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    distributed.initialize(
        f"file://{rendezvous}", world, rank,
        backend=distributed.default_backend(world, device),
    )
    return dev


@contextlib.contextmanager
def world_of_one(device: str = "cuda"):
    """This process as a job of one rank, for as long as the block runs
    (the mesh needs a process group even then); yields its device."""
    with tempfile.TemporaryDirectory(prefix="pollen-rank-") as tmp:
        dev = init_rank(0, 1, os.path.join(tmp, "rendezvous"), device)
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def _rank_main(rank, fn, world, device, threads, out_dir, args):
    torch.set_num_threads(threads)
    dev = init_rank(rank, world, os.path.join(out_dir, "rendezvous"), device)
    result = fn(rank, world, dev, *args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def run(
    fn: Callable[..., Any],
    n: int,
    *args,
    device: str = "cuda",
    deadline: float = 600.0,
    threads: Optional[int] = None,
) -> List[Any]:
    """Run ``fn(rank, n, rank_device, *args)`` in ``n`` spawned ranks and
    return their results in rank order. Raises with the failing rank's
    traceback, or TimeoutError after ``deadline`` seconds; either way
    no rank is left running. ``threads`` caps each rank's torch threads
    (default: the machine's cores shared out, at least 1)."""
    if torch.device(device).type == "cuda":
        from ..kernels import _build

        _build.load()
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // n)
    with tempfile.TemporaryDirectory(prefix="pollen-ranks-") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, n, device, threads, tmp, args),
            nprocs=n, join=False, start_method="spawn",
        )
        end = time.monotonic() + deadline
        try:
            # join kills every rank as soon as one fails, and raises with
            # its traceback.
            while not ctx.join(timeout=max(0.0, end - time.monotonic())):
                if time.monotonic() >= end:
                    raise TimeoutError(
                        f"{n} ranks of {getattr(fn, '__name__', fn)} passed "
                        f"their {deadline:.0f} s deadline"
                    )
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
