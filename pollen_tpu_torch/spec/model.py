"""Clarity-first GFA object model: the executable-specification layer.

This module plays the role that ``mygfa`` plays in the reference project
(reference: mygfa/mygfa/gfa.py): a small, readable, obviously-correct data
model for GFA variation graphs. The fast flat engine in
:mod:`pollen_tpu_torch.flatgfa` is tested for exact-output equality
against programs written over this model (see
:mod:`pollen_tpu_torch.spec.commands`).

Conventions follow odgi / the GFA1 spec:

* An orientation is a bool; ``True`` means forward (``+``).
* Emission order is normalized: headers, then segments sorted by name
  (as *strings*, so ``"10" < "2"``), then paths sorted by name, then links
  sorted by their canonical text form.
* A link's canonical text form flips the link (reversing both handles)
  when the destination segment name sorts before the source segment name,
  or for a reversed self-link.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, TextIO, Tuple

# ---------------------------------------------------------------------------
# Sequences
# ---------------------------------------------------------------------------

_COMPLEMENT = str.maketrans("ACGTN", "TGCAN")

_SEQ_RE = re.compile(r"[ACGTN]*\Z")


def revcomp(seq: str) -> str:
    """Reverse-complement a nucleotide sequence (N maps to N)."""
    return seq.translate(_COMPLEMENT)[::-1]


def check_seq(seq: str) -> str:
    """Validate that a string is a legal nucleotide sequence."""
    if not _SEQ_RE.match(seq):
        raise ValueError(f"illegal nucleotide sequence: {seq!r}")
    return seq


def chop_seq(seq: str, limit: int) -> List[str]:
    """Split a sequence into pieces of at most ``limit`` characters."""
    return [seq[i : i + limit] for i in range(0, len(seq), limit)]


# ---------------------------------------------------------------------------
# CIGAR alignments
# ---------------------------------------------------------------------------

_CIGAR_RE = re.compile(r"(\d+)([MIDN])")


@dataclass(frozen=True)
class Cigar:
    """A CIGAR alignment: a sequence of (count, op) pairs.

    Ops are single characters among ``M`` (match), ``I`` (insertion),
    ``D`` (deletion), and ``N`` (gap). We keep the GFA-spec opcode mapping
    (the reference's flatgfa printer swaps D and I; its mygfa layer and the
    spec both keep them straight — see SURVEY.md "parity hazards").
    """

    ops: Tuple[Tuple[int, str], ...]

    @classmethod
    def parse(cls, text: str) -> "Cigar":
        return cls(tuple((int(n), op) for n, op in _CIGAR_RE.findall(text)))

    def __str__(self) -> str:
        return "".join(f"{n}{op}" for n, op in self.ops)


NO_OVERLAP = Cigar(((0, "M"),))


# ---------------------------------------------------------------------------
# Core entities
# ---------------------------------------------------------------------------


@dataclass(frozen=True, order=True)
class Handle:
    """An oriented reference to a segment, by name."""

    name: str
    forward: bool

    def flip(self) -> "Handle":
        return Handle(self.name, not self.forward)

    @property
    def ori_char(self) -> str:
        return "+" if self.forward else "-"

    def __str__(self) -> str:
        # Path-style rendering: "12+".
        return self.name + self.ori_char


def parse_handle(name: str, ori: str) -> Handle:
    if ori not in ("+", "-"):
        raise ValueError(f"bad orientation {ori!r}")
    return Handle(name, ori == "+")


@dataclass(frozen=True)
class Segment:
    """A named nucleotide sequence."""

    name: str
    seq: str

    def revcomp(self) -> "Segment":
        return Segment(self.name, revcomp(self.seq))

    def __str__(self) -> str:
        return f"S\t{self.name}\t{self.seq}"


@dataclass(frozen=True, order=True)
class Link:
    """An edge between two oriented segments, with a CIGAR overlap."""

    src: Handle
    dst: Handle
    overlap: Cigar

    def flip(self) -> "Link":
        """The equivalent link in the opposite direction."""
        return Link(self.dst.flip(), self.src.flip(), self.overlap)

    def canonical(self) -> "Link":
        """The canonical one of {self, self.flip()} for text emission."""
        if self.dst.name < self.src.name:
            return self.flip()
        if self.src.name == self.dst.name and not self.src.forward:
            return self.flip()
        return self

    def __str__(self) -> str:
        lnk = self.canonical()
        return "\t".join(
            [
                "L",
                lnk.src.name,
                lnk.src.ori_char,
                lnk.dst.name,
                lnk.dst.ori_char,
                str(lnk.overlap),
            ]
        )


@dataclass
class Path:
    """A named walk through the graph."""

    name: str
    steps: List[Handle]
    overlaps: Optional[List[Cigar]] = None

    def without_overlaps(self) -> "Path":
        return Path(self.name, self.steps, None)

    def __str__(self) -> str:
        olap = (
            ",".join(str(c) for c in self.overlaps) if self.overlaps else "*"
        )
        return "\t".join(
            ["P", self.name, ",".join(str(s) for s in self.steps), olap]
        )


@dataclass
class Bed:
    """One region record from a BED file (with an extra name column, as
    consumed by ``inject``)."""

    path: str
    lo: int
    hi: int
    label: str = ""

    @classmethod
    def parse(cls, line: str) -> "Bed":
        cols = line.split("\t")
        path, lo, hi = cols[:3]
        label = cols[3] if len(cols) > 3 else ""
        return cls(path, int(lo), int(hi), label)

    def __str__(self) -> str:
        return f"{self.path}\t{self.lo}\t{self.hi}\t{self.label}"


# ---------------------------------------------------------------------------
# The graph
# ---------------------------------------------------------------------------


@dataclass
class Graph:
    """A whole GFA file: headers, segments, links, and paths.

    ``segments`` and ``paths`` are insertion-ordered dicts keyed by name;
    many analyses iterate them in file order, so the order matters.
    """

    headers: List[str] = field(default_factory=list)
    segments: Dict[str, Segment] = field(default_factory=dict)
    links: List[Link] = field(default_factory=list)
    paths: Dict[str, Path] = field(default_factory=dict)

    # -- parsing ----------------------------------------------------------

    @classmethod
    def parse_lines(cls, lines: Iterator[str]) -> "Graph":
        graph = cls()
        for raw in lines:
            line = raw.strip()
            if not line:
                continue
            fields = line.split()
            kind = fields[0]
            if kind == "H":
                graph.headers.append(line)
            elif kind == "S":
                seg = Segment(fields[1], check_seq(fields[2]))
                graph.segments[seg.name] = seg
            elif kind == "L":
                graph.links.append(
                    Link(
                        parse_handle(fields[1], fields[2]),
                        parse_handle(fields[3], fields[4]),
                        Cigar.parse(fields[5]),
                    )
                )
            elif kind == "P":
                steps = [
                    parse_handle(s[:-1], s[-1]) for s in fields[2].split(",")
                ]
                overlaps = (
                    None
                    if fields[3] == "*"
                    else [Cigar.parse(c) for c in fields[3].split(",")]
                )
                if overlaps is not None and len(overlaps) not in (
                    len(steps),
                    len(steps) - 1,
                ):
                    raise ValueError(
                        f"path {fields[1]}: {len(overlaps)} overlaps for "
                        f"{len(steps)} steps"
                    )
                graph.paths[fields[1]] = Path(fields[1], steps, overlaps)
            else:
                raise ValueError(f"unknown GFA line kind {kind!r}")
        return graph

    @classmethod
    def parse(cls, infile: TextIO) -> "Graph":
        return cls.parse_lines(iter(infile))

    @classmethod
    def parse_file(cls, filename: str) -> "Graph":
        with open(filename, "r", encoding="utf-8") as f:
            return cls.parse(f)

    # -- emission ---------------------------------------------------------

    def emit(self, outfile: TextIO, include_links: bool = True) -> None:
        """Write the graph in normalized GFA order."""
        for header in self.headers:
            print(header, file=outfile)
        for name in sorted(self.segments):
            print(self.segments[name], file=outfile)
        for name in sorted(self.paths):
            print(self.paths[name], file=outfile)
        if include_links:
            for text in sorted(str(lnk) for lnk in self.links):
                print(text, file=outfile)


# ---------------------------------------------------------------------------
# Derived indexes (reference: mygfa/mygfa/preprocess.py)
# ---------------------------------------------------------------------------


def step_index(graph: Graph) -> Dict[str, List[Tuple[str, int, bool]]]:
    """For each segment, the list of (path name, step index, orientation)
    crossings over it, in path-then-step order."""
    crossings: Dict[str, List[Tuple[str, int, bool]]] = {
        name: [] for name in graph.segments
    }
    for path in graph.paths.values():
        for i, step in enumerate(path.steps):
            crossings[step.name].append((path.name, i, step.forward))
    return crossings


AdjacencyMap = Dict[Handle, List[Handle]]


def adjacency(graph: Graph) -> Tuple[AdjacencyMap, AdjacencyMap]:
    """In- and out-adjacency maps keyed by oriented handle.

    Every segment gets entries for both orientations, even if unlinked.
    """
    ins: AdjacencyMap = {}
    outs: AdjacencyMap = {}
    for name in graph.segments:
        for fwd in (True, False):
            ins[Handle(name, fwd)] = []
            outs[Handle(name, fwd)] = []
    for link in graph.links:
        outs[link.src].append(link.dst)
        ins[link.dst].append(link.src)
    return ins, outs


def step_seq(graph: Graph, step: Handle) -> str:
    """The sequence contributed by one oriented step."""
    seq = graph.segments[step.name].seq
    return seq if step.forward else revcomp(seq)


def path_sequences(graph: Graph) -> Dict[str, str]:
    """The full nucleotide sequence charted by each path."""
    return {
        name: "".join(step_seq(graph, s) for s in path.steps)
        for name, path in graph.paths.items()
    }


def graph_maxes(graph: Graph) -> Tuple[int, int, int]:
    """(number of segments, max crossings over any one segment, number of
    paths) — the static dimensions a fixed-size accelerator needs."""
    crossings = step_index(graph)
    max_steps = max((len(c) for c in crossings.values()), default=0)
    return len(graph.segments), max_steps, len(graph.paths)


def without_overlaps(paths: Dict[str, Path]) -> Dict[str, Path]:
    return {name: p.without_overlaps() for name, p in paths.items()}


if __name__ == "__main__":  # python -m pollen_tpu_torch.spec.model [--nl]
    # Round-trip a GFA file through the data model: parse stdin, emit
    # to stdout, links suppressed under --nl (reference:
    # mygfa/mygfa/__main__.py).
    import sys as _sys

    _g = Graph.parse(_sys.stdin)
    _g.emit(_sys.stdout, "--nl" not in _sys.argv[1:])
