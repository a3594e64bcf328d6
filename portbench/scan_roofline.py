"""The share of its bound that a scan kernel reaches in a traced run:
K6 (``SegScanOp``, the scan route's segment scan) and K8
(``RunScanOp``, the runs route's run scan), each a pass of
``csrc/common.cuh``'s ``scan_single`` over a padded index.

A pass moves at least 16 bytes an element: it reads two int32 inputs
(K6 the step's path id and its ``run_start``, K8 the run's path id and
its ``run_count``) and writes two int32 cumsums. The mask's bit words
(at most P / 8 bytes, read from shared memory or the L2 cache) and the
look-back's descriptors are left out: that lowers the bound, so the
share reads low, never past 100% while the time is whole. The bound is
those bytes at the H100 SXM's 3.35 TB/s (``roofline.HBM_BPS``).

The program's counters say how large a pass is and how many a call
makes: ``depth.scan_elements`` over ``depth.scan_passes`` is a pass's
padded elements, ``depth.scan_passes`` over ``depth.calls`` a call's
passes (1 on the scan route, one a mask on the runs route; the
harness's direct calls of the route's device part, in warm-up and beside
the traced calls, add passes and no call, so the share reads high by
their share of the run's passes, under 1%). A pass's time is the
trace's summed time of the kernel whose name holds the Op's, over the
passes of the traced calls. The share is None where that kernel is not
among the trace's largest device operations or the program keeps no
such counters (a program before them), and never 0.
"""

from __future__ import annotations

from . import roofline, spans

BYTES_PER_ELEMENT = 16
SEG_SCAN, RUN_SCAN = "SegScanOp", "RunScanOp"


def roofline_pct(run, op: str):
    """100 x the least time of a pass over the time a pass of the kernel
    whose name holds ``op`` took in the traced calls, in %; None off the
    card, untraced, or where the trace or the counters hold nothing."""
    tr = run.trace
    if not (run.traced and run.device.type == "cuda" and tr and tr.get("calls")):
        return None
    kernel_s = sum(s for name, s in tr["device_ops"] if op in name)
    c = spans.counters()
    passes, elements, calls = (c.get(k) for k in (
        "depth.scan_passes", "depth.scan_elements", "depth.calls"))
    if kernel_s <= 0 or not (passes and elements and calls):
        return None
    traced_passes = tr["calls"] * passes / calls
    least_s = roofline.least_s(BYTES_PER_ELEMENT * elements / passes)
    return 100 * least_s / (kernel_s / traced_passes)
