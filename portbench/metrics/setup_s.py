"""setup_s: process start to the window's start (imports, kernel load or
build, input generation, ingest, warm-up), s, host clock."""


def read(run):
    return run.setup_s
