"""queries_per_s: subset queries answered in the window over the
window's length (a batch call answers one query a mask)."""


def read(run):
    return run.answered / run.window_s if run.answered and run.window_s > 0 else None
