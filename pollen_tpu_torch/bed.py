"""FlatBED: BED interval files in the flat-arena style.

The port's own copy of the JAX package's pollen_tpu/bed.py (``FlatBed``,
``parse_bed``, ``parse_bed_file``, ``run_bed_intersect``,
``windows_bed``). Reference semantics: flatgfa/src/flatbed.rs — name
spans into a byte pool plus (start, end) u64 intervals, with
bedtools-style clipped intersection. The parser is vectorized NumPy like
the GFA parser.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

from .flatgfa import parse_uints, ragged_gather

_TAB = 9
_NEWLINE = 10


@dataclasses.dataclass
class FlatBed:
    """A parsed BED file: intervals with shared name bytes.

    ``label_*`` carries the optional 4th column (used by ``inject`` to
    name new paths).
    """

    name_data: np.ndarray  # uint8[*]
    name_span: np.ndarray  # uint32[E, 2]
    start: np.ndarray  # uint64[E]
    end: np.ndarray  # uint64[E]
    label_data: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint8)
    )
    label_span: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.uint32)
    )

    @property
    def num_entries(self) -> int:
        return self.start.shape[0]

    def entry_name(self, i: int) -> bytes:
        lo, hi = self.name_span[i]
        return self.name_data[lo:hi].tobytes()

    def entry_label(self, i: int) -> bytes:
        if self.label_span.shape[0] <= i:
            return b""
        lo, hi = self.label_span[i]
        return self.label_data[lo:hi].tobytes()

    def names(self) -> List[bytes]:
        return [self.entry_name(i) for i in range(self.num_entries)]

    def name_codes(self) -> np.ndarray:
        """int64[E]: a factorized id per distinct entry name."""
        seen: dict = {}
        return np.array(
            [seen.setdefault(n, len(seen)) for n in self.names()],
            dtype=np.int64,
        )

    def intersections(self, other: "FlatBed", i: int) -> Iterator[Tuple[bytes, int, int]]:
        """Entries of ``other`` that intersect entry ``i`` of self,
        clipped to the overlap (reference: flatbed.rs get_intersects).
        Yields (name, start, end) in other's entry order."""
        name = self.entry_name(i)
        lo = max(int(self.start[i]), 0)
        hi = int(self.end[i])
        starts = np.maximum(other.start, np.uint64(lo))
        ends = np.minimum(other.end, np.uint64(hi))
        for j in range(other.num_entries):
            if other.entry_name(j) == name and ends[j] > starts[j]:
                yield name, int(starts[j]), int(ends[j])


def parse_bed(data: bytes) -> FlatBed:
    """Parse BED text (name, start, end; extra columns ignored)."""
    from .flatgfa import GFAParseError

    try:
        return _parse_bed(data)
    except GFAParseError:
        raise
    except (ValueError, IndexError) as exc:
        raise GFAParseError(f"malformed BED structure: {exc}") from exc


def _parse_bed(data: bytes) -> FlatBed:
    buf = np.frombuffer(data, dtype=np.uint8)
    newlines = np.flatnonzero(buf == _NEWLINE)
    starts = np.concatenate(([0], newlines + 1))
    ends = np.concatenate((newlines, [buf.shape[0]]))
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    if starts.size:
        # Skip comment/header lines (reference: flatbed.rs parse_line).
        not_comment = buf[starts] != ord("#")
        starts, ends = starts[not_comment], ends[not_comment]
    if starts.size == 0:
        return FlatBed(
            np.zeros(0, np.uint8),
            np.zeros((0, 2), np.uint32),
            np.zeros(0, np.uint64),
            np.zeros(0, np.uint64),
        )

    tabs = np.flatnonzero(buf == _TAB)
    off = np.searchsorted(tabs, starts)

    def kth(k):
        idx = off + k
        pos = tabs[np.minimum(idx, tabs.shape[0] - 1)]
        pos = np.where(idx < tabs.shape[0], pos, ends)
        return np.minimum(pos, ends)

    t0, t1, t2, t3 = kth(0), kth(1), kth(2), kth(3)
    name_lens = t0 - starts
    name_data = ragged_gather(buf, starts, name_lens)
    n_end = np.cumsum(name_lens)
    name_span = np.stack([n_end - name_lens, n_end], axis=1).astype(np.uint32)

    lo = parse_uints(buf, t0 + 1, t1 - (t0 + 1)).astype(np.uint64)
    hi = parse_uints(buf, t1 + 1, t2 - (t1 + 1)).astype(np.uint64)

    # Optional 4th column (inject's new-path label).
    lab_lo = np.minimum(t2 + 1, t3)
    lab_lens = t3 - lab_lo
    label_data = ragged_gather(buf, lab_lo, lab_lens)
    l_end = np.cumsum(lab_lens)
    label_span = np.stack([l_end - lab_lens, l_end], axis=1).astype(np.uint32)
    return FlatBed(name_data, name_span, lo, hi, label_data, label_span)


def parse_bed_file(filename: str) -> FlatBed:
    with open(filename, "rb") as f:
        return parse_bed(f.read())


def run_bed_intersect(a: FlatBed, b: FlatBed) -> str:
    """CLI `bed -a A -b B` output (reference: cli/cmds.rs bed_intersect):
    for each entry of A, every clipped intersecting entry of B."""
    lines = []
    for i in range(a.num_entries):
        for name, lo, hi in a.intersections(b, i):
            lines.append(f"{name.decode()}\t{lo}\t{hi}")
    return "".join(line + "\n" for line in lines)


def windows_bed(name: bytes, start: int, end: int, size: int) -> FlatBed:
    """Equal-size windows along [start, end) as a FlatBed
    (reference: ops/window_depth.rs Windows)."""
    lo = np.arange(start, end, size, dtype=np.uint64)
    hi = np.minimum(lo + np.uint64(size), np.uint64(end))
    name_data = np.frombuffer(name, dtype=np.uint8)
    span = np.repeat(
        np.array([[0, len(name)]], np.uint32), lo.shape[0], axis=0
    )
    return FlatBed(name_data.copy(), span, lo, hi)
