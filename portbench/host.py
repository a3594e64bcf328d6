"""The host's side of a run, read before and after the window and
printed on standard error: page faults and context switches per call,
the process's threads and CPUs, and transparent huge pages (the
system's mode and the process's huge-page-backed anonymous memory).
Runs that come out fast or slow as a whole can be told apart by these.
Each field is left out where the system cannot say."""

from __future__ import annotations

import os
import pathlib
import resource

THP = pathlib.Path("/sys/kernel/mm/transparent_hugepage")


def _read(path) -> str | None:
    try:
        return pathlib.Path(path).read_text()
    except OSError:
        return None


def _bracketed(text: str | None) -> str | None:
    """The selected word of a ``[always] madvise never`` line."""
    if text and "[" in text:
        return text.split("[", 1)[1].split("]", 1)[0]
    return None


def _status_kb(text: str | None, key: str) -> int | None:
    for line in (text or "").splitlines():
        if line.startswith(key + ":"):
            return int(line.split()[1])
    return None


def reading() -> dict:
    """The counters that ``after`` takes differences of."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"minflt": ru.ru_minflt, "majflt": ru.ru_majflt,
            "nvcsw": ru.ru_nvcsw, "nivcsw": ru.ru_nivcsw}


def after(before: dict, calls: int) -> dict:
    """Per call differences since ``before``, and the state now."""
    now = reading()
    out = {f"{k}_per_call": (now[k] - before[k]) / max(calls, 1) for k in now}
    try:
        out["cpus_allowed"] = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        pass
    stat = _read("/proc/self/stat")
    if stat:
        out["last_cpu"] = int(stat.rsplit(")", 1)[1].split()[36])
    status = _read("/proc/self/status")
    threads = _status_kb(status, "Threads")
    if threads is not None:
        out["threads"] = threads
    rss = _status_kb(status, "VmRSS")
    if rss is not None:
        out["rss_kb"] = rss
    huge = _status_kb(_read("/proc/self/smaps_rollup"), "AnonHugePages")
    if huge is not None:
        out["anon_huge_kb"] = huge
    for name in ("enabled", "defrag"):
        mode = _bracketed(_read(THP / name))
        if mode:
            out[f"thp_{name}"] = mode
    return out
