"""Masked segment scan (K6): the scan route's two cumsums over the
(segment, path)-sorted step list.

    csum_w[i]     = sum_{j <= i} mask[path[j]]
    csum_first[i] = number of j <= i whose step is the first selected
                    step of its (segment, path) group

The boundary stage (kernels/gatherb.py, K7) turns them into per-segment
depth and distinct-path depth. A port of
pollen_tpu/kernels/segscan.py ``masked_depth_cumsums`` with its
``head_carry`` contract: ``head_carry`` selected steps of position 0's
group lie before this array (a shard's left neighbours), so that group's
first flag does not fire here; positions whose ``run_start`` is not
their own index continue the group before them, and negative entries
(groups begun to the left) never start one. The carry is a host int, or
a 0-dim int32 tensor on the steps' device (the sharded query's look-back
result, parallel/sharded.py), which the kernel reads itself so that the
caller never waits for it.

The wrapper launches ``csrc/scan.cu`` pollen_seg_scan on a CUDA tensor
and runs the plain version, which follows the reference's prefix-max
formulation, only on a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from . import _build

# Launch count of the CUDA kernel (plain-version calls do not count).
launches = {"seg_scan": 0}


def lookup_mask(mask: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int32 ``mask[ids]``, 0 for ids outside the mask (the padding
    sentinel path, and paths past a mask shorter than the graph's)."""
    ext = torch.cat([mask.to(torch.int32), mask.new_zeros(1, dtype=torch.int32)])
    n = mask.shape[0]
    ids = ids.long()
    return ext[torch.where((ids >= 0) & (ids < n), ids, n)]


HeadCarry = Union[int, torch.Tensor]


def masked_depth_cumsums_plain(
    path_sorted: torch.Tensor,
    run_start: torch.Tensor,
    mask: torch.Tensor,
    head_carry: HeadCarry = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`masked_depth_cumsums`: the reference's
    formulation, a running max of the exclusive cumsum exposed at group
    starts (-head_carry spliced in at position 0 when it starts none)."""
    w = lookup_mask(mask, path_sorted)
    csw = torch.cumsum(w, 0, dtype=torch.int32)
    pos = torch.arange(w.shape[0], dtype=torch.int64, device=w.device)
    is_start = run_start.long() == pos
    y = torch.where(is_start, csw - w, torch.full_like(w, -1))
    if w.shape[0]:
        # No host read of the carry, whether an int or a device scalar.
        hc = torch.as_tensor(head_carry, dtype=y.dtype, device=y.device)
        y[0] = torch.where(is_start[0], y[0], torch.maximum(y[0], -hc))
    base = torch.cummax(y, 0).values
    first = ((w > 0) & (csw - base == 1)).to(torch.int32)
    return csw, torch.cumsum(first, 0, dtype=torch.int32)


def check_scan_inputs(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor):
    """Refuse inputs the scan kernels do not read."""
    for t in (a, b):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError("scan inputs must be contiguous 1-D int32")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(
            f"scan inputs {tuple(a.shape)} on {a.device} and "
            f"{tuple(b.shape)} on {b.device} differ"
        )
    if a.shape[0] >= 2**31:
        raise ValueError("scan inputs must hold fewer than 2^31 entries")
    if mask.dim() != 1:
        raise ValueError(f"mask must be 1-D, got shape {tuple(mask.shape)}")


def scan_scratch(n: int, device) -> torch.Tensor:
    """Scratch of one single-pass scan (K6 or K8) over n elements, sized
    by csrc/scan.cu: a ticket counter and one 16-byte look-back
    descriptor a partition; its launch zeroes them."""
    nbytes = _build.load().pollen_scan_scratch_bytes(n)
    return torch.empty(-(-nbytes // 4), dtype=torch.int32, device=device)


def check_head_carry(head_carry: torch.Tensor, device) -> None:
    """Refuse a device carry the kernel does not read (its value, a
    count >= 0, is not checked: that would wait for the device)."""
    if head_carry.dtype != torch.int32 or head_carry.dim() != 0:
        raise TypeError(
            f"a tensor head_carry must be a 0-dim int32, got "
            f"{head_carry.dtype} of shape {tuple(head_carry.shape)}"
        )
    if head_carry.device != device:
        raise ValueError(f"head_carry on {head_carry.device}, steps on {device}")


def masked_depth_cumsums(
    path_sorted: torch.Tensor,
    run_start: torch.Tensor,
    mask: torch.Tensor,
    head_carry: HeadCarry = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(csum_w, csum_first), both inclusive int32 of the steps' length.
    ``mask`` is 0/1 per path (paths past its end read 0); ``head_carry``
    is a count >= 0, as an int or a 0-dim int32 tensor on the steps'
    device. CUDA: csrc/scan.cu pollen_seg_scan."""
    check_scan_inputs(path_sorted, run_start, mask)
    device = path_sorted.device
    carry_dev = None
    if isinstance(head_carry, torch.Tensor):
        check_head_carry(head_carry, device)
        carry_dev, head_carry = head_carry, 0
    head_carry = int(head_carry)
    if head_carry < 0:
        raise ValueError(f"head_carry is a count, got {head_carry}")
    if device.type == "cpu":
        return masked_depth_cumsums_plain(
            path_sorted, run_start, mask,
            head_carry if carry_dev is None else carry_dev,
        )
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    from .ellscan import alloc_outputs, kernel_mask

    n = path_sorted.shape[0]
    mask, elem, n_paths, n_words = kernel_mask(mask, device)
    csw, csf, words = alloc_outputs([n, n], n_words, device)
    scratch = scan_scratch(n, device)
    _build.check(
        "pollen_seg_scan",
        _build.load().pollen_seg_scan(
            path_sorted.data_ptr(), run_start.data_ptr(), n, head_carry,
            None if carry_dev is None else carry_dev.data_ptr(),
            mask.data_ptr(), elem, n_paths, words.data_ptr(), n_words,
            scratch.data_ptr(), csw.data_ptr(), csf.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        ),
    )
    launches["seg_scan"] += 1
    return csw, csf


def depth_uniq_from_cumsums(
    csw: torch.Tensor, csf: torch.Tensor, seg_bounds: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boundary stage: per-segment (depth, uniq), int32 (K7)."""
    from .gatherb import gather_boundary_diff

    return gather_boundary_diff((csw, csf), seg_bounds)
