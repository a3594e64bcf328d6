"""ingest_to_device_s: seconds a build in ``build_graph``'s stage
``pollen.ingest.to_device`` (counters ``ingest.to_device.s`` over
``ingest.builds``), s."""

from portbench import spans


def read(run):
    return spans.ingest_stage_s(run, "to_device")
