"""ingest_sort_s: seconds a build in ``build_graph``'s stage
``pollen.ingest.sort`` (counters ``ingest.sort.s`` over
``ingest.builds``), s."""

from portbench import spans


def read(run):
    return spans.ingest_stage_s(run, "sort")
