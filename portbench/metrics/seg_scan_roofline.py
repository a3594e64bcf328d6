"""seg_scan_roofline: K6's least time a pass (16 bytes a padded step at
3.35 TB/s, ``portbench.scan_roofline``) over its traced time a pass, %
(the scan route)."""

from portbench import scan_roofline


def read(run):
    return scan_roofline.roofline_pct(run, scan_roofline.SEG_SCAN)
