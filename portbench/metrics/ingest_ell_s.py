"""ingest_ell_s: seconds a build in ``build_graph``'s stage
``pollen.ingest.ell`` (counters ``ingest.ell.s`` over
``ingest.builds``), s."""

from portbench import spans


def read(run):
    return spans.ingest_stage_s(run, "ell")
