"""ingest_s: the program's ingest (``build_graph``, with ``build_ell``)
of the cell's arena, host clock ending in a synchronise, s."""


def read(run):
    return run.ingest_s if run.traced and run.ingest_s > 0 else None
