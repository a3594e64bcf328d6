"""The collectives of the parallel layer, with one rule by backend.

NCCL moves CUDA tensors, one rank per card. Gloo is what CPU jobs use,
and what several ranks sharing one card use (NCCL refuses two ranks on
one device). Which gloo collectives take CUDA tensors depends on the
torch build, so a gloo group always carries host tensors: each helper
copies its input to the host, runs the collective there and copies the
result back to the input's device. Only calls that every torch 2.x
has are made: under gloo ``all_gather`` into a list and ``all_reduce``
(a reduce-scatter is the sum, then this rank's piece); under NCCL
``all_gather_into_tensor``, ``all_reduce`` and ``reduce_scatter_tensor``.

``group=None`` is the whole job (the mesh's step axes, ``("host",
"chip")``: the mesh spans every rank).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def host_staged(group=None) -> bool:
    """Whether ``group``'s collectives run on host copies (gloo)."""
    return dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked in group-rank order: (world, *t.shape)
    on ``t``'s device."""
    n = dist.get_world_size(group)
    if host_staged(group):
        h = t.detach().cpu().contiguous()
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=group)
        return torch.stack(parts).to(t.device)
    out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t`` (a new tensor on ``t``'s device)."""
    if host_staged(group):
        h = t.detach().cpu().clone()
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def reduce_scatter_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's piece of the sum of every rank's ``t``, cut into equal
    pieces along dim 0 (whose size the group's size must divide)."""
    n = dist.get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split over {n} ranks")
    piece = t.shape[0] // n
    if host_staged(group):
        r = dist.get_rank(group)
        return all_reduce_sum(t, group)[r * piece : (r + 1) * piece]
    out = torch.empty((piece, *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


def gather_shards(t: torch.Tensor, group=None) -> torch.Tensor:
    """A sharded output whole again: every rank's ``t`` joined along its
    last axis in group-rank order (the reference's global array)."""
    parts = all_gather(t, group)
    return torch.cat(list(parts.unbind(0)), dim=-1)
