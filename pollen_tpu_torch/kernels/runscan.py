"""Masked run scan (K8): the runs route's two cumsums over the run
index (one entry per distinct (segment, path) pair).

    csum_wc[i] = sum_{j <= i} mask[run_path[j]] * run_count[j]   (depth)
    csum_w[i]  = sum_{j <= i} mask[run_path[j]]                  (uniq)

Ingest already collapsed repeated crossings, so no first-occurrence
logic is needed. A port of pollen_tpu/kernels/runscan.py
``masked_run_cumsums``; the wrapper launches ``csrc/scan.cu``
pollen_run_scan (the single-pass look-back scan K6 runs on too) on a
CUDA tensor and runs the plain version only on a CPU tensor. Sums are
int32 and wrap as the reference's do.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .segscan import check_scan_inputs, lookup_mask, scan_scratch

# Launch count of the CUDA kernel (plain-version calls do not count).
launches = {"run_scan": 0}


def masked_run_cumsums_plain(
    run_path: torch.Tensor, run_count: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`masked_run_cumsums`."""
    w = lookup_mask(mask, run_path)
    return (
        torch.cumsum(w * run_count, 0, dtype=torch.int32),
        torch.cumsum(w, 0, dtype=torch.int32),
    )


def masked_run_cumsums(
    run_path: torch.Tensor, run_count: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted cumsum, mask cumsum), both inclusive int32 of the run
    index's length. ``mask`` is 0/1 per path (paths past its end read
    0). CUDA: csrc/scan.cu pollen_run_scan."""
    check_scan_inputs(run_path, run_count, mask)
    device = run_path.device
    if device.type == "cpu":
        return masked_run_cumsums_plain(run_path, run_count, mask)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    from .ellscan import alloc_outputs, kernel_mask

    n = run_path.shape[0]
    mask, elem, n_paths, n_words = kernel_mask(mask, device)
    cswc, csw, words = alloc_outputs([n, n], n_words, device)
    scratch = scan_scratch(n, device)
    _build.check(
        "pollen_run_scan",
        _build.load().pollen_run_scan(
            run_path.data_ptr(), run_count.data_ptr(), n, mask.data_ptr(),
            elem, n_paths, words.data_ptr(), n_words, scratch.data_ptr(),
            cswc.data_ptr(), csw.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        ),
    )
    launches["run_scan"] += 1
    return cswc, csw
