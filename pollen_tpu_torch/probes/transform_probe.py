"""Put a number behind keeping the transforms (chop, crush) on the host:
the port of the TPU probe ``probes/transform_probe.py``.

Each stage times the transform's host NumPy stages against a torch
formulation of the same stages on the device:

    chop   count, scan and expansion of the new step ids (limit 3);
           the device expands with the padded searchsorted-gather form
           (output sizes depend on the data)
    crush  the mask and scan of the N-run squash over the sequence bytes
           (no compaction: the byte gather itself is the emit path)

Both formulations are checked equal. The transforms stay host NumPy in
the port, as in the reference. Run on the card (default) or with
``--device cpu``:

    python -m pollen_tpu_torch.probes.transform_probe chop crush
    POLLEN_BENCH_STEPS=30000 POLLEN_BENCH_SEGS=4096 \\
        python -m pollen_tpu_torch.probes.transform_probe --device cpu

The graph is ``synth.synth_graph`` at POLLEN_BENCH_STEPS / SEGS / PATHS
(defaults 2^22 / 2^18 / 128). Device times are CUDA events around one
call (``timing.events_us``, median of 5); host times are the host
clock.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time

import numpy as np
import torch

from .timing import events_us

STAGES = ("chop", "crush")
CHOP_LIMIT = 3


def _host_s(fn, reps=3):
    """(median seconds, last result) of ``fn`` on the host clock."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def _device_s(fn, device):
    """(median seconds, last result) of ``fn`` on ``device``: CUDA
    events on the card, the host clock on the CPU."""
    last = [None]

    def call():
        last[0] = fn()

    us, _ = events_us(call, device)
    return us / 1e6, last[0]


def chop_ids_host(seg_len: np.ndarray, steps: np.ndarray, limit: int):
    """The new segment id of every piece of every step (forward order):
    count, scan and expansion, as ``ops.transform.chop`` computes them."""
    pieces = np.maximum((seg_len + limit - 1) // limit, 0).astype(np.int64)
    first_new = np.cumsum(pieces) - pieces
    s_seg = (steps >> 1).astype(np.int64)
    counts = pieces[s_seg]
    owner = np.repeat(np.arange(steps.shape[0]), counts)
    offs = np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    return first_new[s_seg[owner]] + offs


def chop_ids_device(seg_len: torch.Tensor, steps: torch.Tensor, limit: int,
                    total: int):
    """:func:`chop_ids_host` on the device: the expansion as a padded
    searchsorted over the count cumsum plus two gathers (``total``, the
    output length, is known ahead, as a static shape would be)."""
    pieces = torch.clamp((seg_len + limit - 1) // limit, min=0)
    first_new = torch.cumsum(pieces, 0) - pieces
    s_seg = steps >> 1
    counts = pieces[s_seg]
    cum = torch.cumsum(counts, 0)
    j = torch.arange(total, dtype=torch.int64, device=steps.device)
    owner = torch.searchsorted(cum, j, right=True)
    off = j - (cum[owner] - counts[owner])
    return first_new[s_seg[owner]] + off


def crush_keep_host(seq: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """The kept bytes' new positions' cumsum of the N-run squash: an N
    after an N in the same segment goes."""
    is_n = seq == ord("N")
    prev = np.concatenate([[False], is_n[:-1]])
    seg_start = np.zeros(seq.shape[0], bool)
    seg_start[starts] = True
    keep = ~(is_n & prev & ~seg_start)
    return np.cumsum(keep, dtype=np.int64)


def crush_keep_device(seq: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """:func:`crush_keep_host` on the device."""
    is_n = seq == ord("N")
    prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=seq.device),
                      is_n[:-1]])
    seg_start = torch.zeros(seq.shape[0], dtype=torch.bool, device=seq.device)
    seg_start[starts] = True
    keep = ~(is_n & prev & ~seg_start)
    return torch.cumsum(keep, 0, dtype=torch.int64)


def stage_chop(g, device, say=print) -> dict:
    """chop: the full host op, its host stages and the device stages."""
    from ..ops.transform import chop

    host_full, out = _host_s(lambda: chop(g, CHOP_LIMIT, with_links=True), 1)
    seg_len = np.asarray(g.seg_len).astype(np.int64)
    steps = np.asarray(g.steps).astype(np.int64)
    host_stages, ids = _host_s(lambda: chop_ids_host(seg_len, steps, CHOP_LIMIT))
    total = ids.shape[0]
    lens_d = torch.from_numpy(seg_len).to(device)
    steps_d = torch.from_numpy(steps).to(device)
    dev, ids_d = _device_s(
        lambda: chop_ids_device(lens_d, steps_d, CHOP_LIMIT, total), device
    )
    equal = total == out.num_steps and np.array_equal(ids, ids_d.cpu().numpy())
    say(f"chop: host full {host_full:.3f}s, host stages {host_stages:.3f}s, "
        f"device stages {dev:.4f}s/op ({total / 1e6:.1f} M new steps) "
        f"[{device.type}] equal={equal}")
    return dict(host_full_s=host_full, host_stages_s=host_stages,
                device_s=dev, new_steps=total, equal=equal)


def stage_crush(g, device, say=print) -> dict:
    """crush: the full host op on seeded ACGTNN bytes, its mask and scan
    stage on the host and on the device."""
    from ..ops.transform import crush

    rng = np.random.default_rng(5)
    seq = rng.choice(np.frombuffer(b"ACGTNN", dtype=np.uint8),
                     g.seq_data.shape[0])
    g2 = dataclasses.replace(g, seq_data=seq)
    host_full, _ = _host_s(lambda: crush(g2), 1)
    starts = np.asarray(g2.seg_seq[:, 0]).astype(np.int64)
    starts = starts[starts < seq.shape[0]]
    host_stages, keep = _host_s(lambda: crush_keep_host(seq, starts))
    seq_d = torch.from_numpy(seq).to(device)
    starts_d = torch.from_numpy(starts).to(device)
    dev, keep_d = _device_s(lambda: crush_keep_device(seq_d, starts_d), device)
    equal = np.array_equal(keep, keep_d.cpu().numpy())
    say(f"crush: host full {host_full:.3f}s ({seq.shape[0] / 1e6:.1f} MB "
        f"seq), host mask+scan {host_stages:.4f}s, device mask+scan "
        f"{dev:.4f}s/op [{device.type}] equal={equal}")
    return dict(host_full_s=host_full, host_stages_s=host_stages,
                device_s=dev, bytes=int(seq.shape[0]), equal=equal)


def main(argv=None) -> int:
    from .ell_probe import bench_shape
    from ..synth import synth_graph

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", help=f"any of {', '.join(STAGES)}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    which = args.stages or list(STAGES)
    bad = [s for s in which if s not in STAGES]
    if bad:
        ap.error(f"unknown stages {bad}; choose from {STAGES}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")
    g = synth_graph(*bench_shape())
    ok = True
    for stage in which:
        res = (stage_chop if stage == "chop" else stage_crush)(
            g, device, say=lambda s: print(s, flush=True)
        )
        ok = ok and res["equal"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
