"""ingest_cross_s: seconds a build in ``build_graph``'s stage
``pollen.ingest.cross`` (counters ``ingest.cross.s`` over
``ingest.builds``), s."""

from portbench import spans


def read(run):
    return spans.ingest_stage_s(run, "cross")
