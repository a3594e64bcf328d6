"""run_scan_roofline: K8's least time a pass (16 bytes a padded run at
3.35 TB/s, ``portbench.scan_roofline``) over its traced time a pass, %
(the runs route)."""

from portbench import scan_roofline


def read(run):
    return scan_roofline.roofline_pct(run, scan_roofline.RUN_SCAN)
