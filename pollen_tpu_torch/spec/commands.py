"""Executable specification of the odgi-style query/transform commands.

Each function here is the readable, obviously-correct version of a graph
analysis (reference: slow_odgi/slow_odgi/*.py — one module per command).
Printer commands write odgi-compatible text to ``out``; transformer
commands return a new :class:`~pollen_tpu_torch.spec.model.Graph`.

The fast engine (:mod:`pollen_tpu_torch.ops`) is golden-tested against
these functions byte-for-byte.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, TextIO, Tuple

from .model import (
    Bed,
    Graph,
    Handle,
    Link,
    NO_OVERLAP,
    Path,
    Segment,
    adjacency,
    chop_seq,
    path_sequences,
    step_index,
    without_overlaps,
)

# A legend maps an old segment name to the half-open integer range
# [first, last) of new segment names that replaced it.
Legend = Dict[str, Tuple[int, int]]


# ---------------------------------------------------------------------------
# Printer commands
# ---------------------------------------------------------------------------


def depth(
    graph: Graph, out: TextIO, subset_paths: Optional[List[str]] = None
) -> None:
    """Per-segment depth table: how many times paths cross each segment,
    plus how many *distinct* paths do (reference: slow_odgi depth.py).

    ``subset_paths`` restricts which crossings are counted (odgi's ``-s``):
    note it filters crossings, not the path list itself.
    """
    wanted = None if subset_paths is None else set(subset_paths)
    print("#node.id\tdepth\tdepth.uniq", file=out)
    for seg, crossings in step_index(graph).items():
        if wanted is not None:
            crossings = [c for c in crossings if c[0] in wanted]
        distinct = {path_name for path_name, _, _ in crossings}
        print(f"{seg}\t{len(crossings)}\t{len(distinct)}", file=out)


def degree(graph: Graph, out: TextIO) -> None:
    """Per-segment degree table: incident link endpoints, counting both
    orientations of the segment (reference: slow_odgi degree.py)."""
    ins, outs = adjacency(graph)
    print("#node.id\tnode.degree", file=out)
    for name in graph.segments:
        total = sum(
            len(adj[Handle(name, fwd)])
            for adj in (ins, outs)
            for fwd in (True, False)
        )
        print(f"{name}\t{total}", file=out)


def flatten(graph: Graph, out: TextIO, fasta_name: str) -> None:
    """Linearize the graph: a FASTA of all segment sequences glued together
    (wrapped at 80 columns) plus a BED locating each path step in that
    linear space (reference: slow_odgi flatten.py)."""
    offsets: Dict[str, Tuple[int, int]] = {}
    pos = 0
    chunks = []
    for seg in graph.segments.values():
        chunks.append(seg.seq)
        offsets[seg.name] = (pos, pos + len(seg.seq))
        pos += len(seg.seq)
    fasta = "".join(chunks)

    print(f">{fasta_name}", file=out)
    for i in range(0, len(fasta), 80):
        print(fasta[i : i + 80], file=out)

    print(
        "#name\tstart\tend\tpath.name\tstrand\tstep.rank", file=out
    )
    for path in graph.paths.values():
        for rank, step in enumerate(path.steps):
            lo, hi = offsets[step.name]
            print(
                f"{fasta_name}\t{lo}\t{hi}\t{path.name}\t"
                f"{step.ori_char}\t{rank}",
                file=out,
            )


def matrix(graph: Graph, out: TextIO) -> None:
    """Sparse adjacency-matrix rendering (reference: slow_odgi matrix.py).

    Deliberately mirrors odgi quirks: the header's nonzero count is twice
    the link count, and every link is printed in both directions without
    deduplication.
    """
    top = max(int(name) for name in graph.segments)
    print(f"{top} {top} {2 * len(graph.links)}", file=out)
    _, outs = adjacency(graph)
    for handle, neighbors in outs.items():
        for nbr in neighbors:
            print(f"{handle.name} {nbr.name} 1", file=out)
            print(f"{nbr.name} {handle.name} 1", file=out)


def overlap(graph: Graph, out: TextIO, query_paths: List[str]) -> None:
    """For each query path, list the other paths sharing at least one
    oriented step with it (reference: slow_odgi overlap.py)."""
    seqs = path_sequences(graph)
    step_sets = {
        name: set(path.steps) for name, path in graph.paths.items()
    }
    header_done = False
    for query in query_paths:
        if query not in graph.paths:
            raise KeyError(f"no such path: {query}")
        for other in graph.paths:
            if other == query or not (step_sets[query] & step_sets[other]):
                continue
            if not header_done:
                print("#path\tstart\tend\tpath.touched", file=out)
                header_done = True
            print(f"{query}\t0\t{len(seqs[query])}\t{other}", file=out)


def paths(graph: Graph, out: TextIO) -> None:
    """List path names (reference: slow_odgi paths.py)."""
    for name in graph.paths:
        print(name, file=out)


def some_paths(graph: Graph, out: TextIO, drop_percent: int = 0) -> None:
    """List path names, optionally dropping a seeded-random percentage —
    used to build subset-path test queries (reference: somepaths.py)."""
    names = list(graph.paths)
    if drop_percent > 0:
        random.seed(4)
        keep = int((100 - drop_percent) / 100 * len(names))
        names[:] = random.sample(names, keep)
    for name in names:
        print(name, file=out)


def validate(graph: Graph, out: TextIO) -> None:
    """Report every adjacent step pair in a path that no link (in either
    direction) supports (reference: slow_odgi validate.py)."""
    _, outs = adjacency(graph)
    for path in graph.paths.values():
        for a, b in zip(path.steps, path.steps[1:]):
            if b not in outs[a] and a.flip() not in outs[b.flip()]:
                print(
                    f"[odgi::validate] error: the path {path.name} "
                    "does not respect the graph topology: the link "
                    f"{a},{b} is missing.",
                    file=out,
                )


def inject_setup(graph: Graph, out: TextIO) -> None:
    """Emit a seeded-random BED query set for testing ``inject``
    (reference: inject_setup.py)."""
    random.seed(4)
    seqs = path_sequences(graph)
    for path in graph.paths.values():
        length = len(seqs[path.name])
        for i in range(random.randint(0, 5)):
            lo = random.randint(0, length - 1)
            hi = random.randint(lo + 1, length)
            print(Bed(path.name, lo, hi, f"{path.name}_{i}"), file=out)


# ---------------------------------------------------------------------------
# Transformer commands
# ---------------------------------------------------------------------------


def renumber_steps(graph: Graph, legend: Legend) -> Dict[str, Path]:
    """Rewrite every path through a renumbering legend: each old step
    expands into the run of new segments that replaced it (reversed, with
    each orientation kept, for backward steps)."""
    new_paths = {}
    for path in graph.paths.values():
        steps: List[Handle] = []
        for step in path.steps:
            first, last = legend[step.name]
            run = [Handle(str(n), step.forward) for n in range(first, last)]
            steps.extend(run if step.forward else reversed(run))
        new_paths[path.name] = Path(path.name, steps, None)
    return new_paths


def chop(graph: Graph, limit: int) -> Graph:
    """Split long segments so none exceeds ``limit`` base pairs,
    renumbering all segments sequentially from 1 and rewriting paths
    (reference: slow_odgi chop.py). Links and overlaps are dropped."""
    legend: Legend = {}
    new_segs: Dict[str, Segment] = {}
    counter = 1
    for seg in graph.segments.values():
        first = counter
        for piece in chop_seq(seg.seq, limit):
            new_segs[str(counter)] = Segment(str(counter), piece)
            counter += 1
        legend[seg.name] = (first, counter)
    return Graph(graph.headers, new_segs, [], renumber_steps(graph, legend))


def crush(graph: Graph) -> Graph:
    """Collapse each within-segment run of N characters to a single N
    (reference: slow_odgi crush.py)."""

    def crush_one(seq: str) -> str:
        out = []
        prev_n = False
        for ch in seq:
            is_n = ch == "N"
            if not (is_n and prev_n):
                out.append(ch)
            prev_n = is_n
        return "".join(out)

    segs = {
        name: Segment(name, crush_one(seg.seq))
        for name, seg in graph.segments.items()
    }
    return Graph(
        graph.headers, segs, graph.links, without_overlaps(graph.paths)
    )


def flip(graph: Graph) -> Graph:
    """Reverse any path that covers more reverse-oriented than
    forward-oriented base pairs, renaming it ``{name}_inv``; then add
    (deduplicated) links so all flipped paths remain valid
    (reference: slow_odgi flip.py)."""

    def mostly_reverse(path: Path) -> bool:
        fwd = rev = 0
        for step in path.steps:
            length = len(graph.segments[step.name].seq)
            if step.forward:
                fwd += length
            else:
                rev += length
        return rev > fwd

    flipped: Dict[str, bool] = {}
    new_paths: Dict[str, Path] = {}
    for name, path in graph.paths.items():
        if mostly_reverse(path):
            steps = [s.flip() for s in reversed(path.steps)]
            new_paths[name] = Path(f"{name}_inv", steps, None)
            flipped[name] = True
        else:
            new_paths[name] = path.without_overlaps()
            flipped[name] = False

    # Links that make each flipped path walkable again.
    added = [
        Link(a, b, NO_OVERLAP)
        for name, path in new_paths.items()
        if flipped[name]
        for a, b in zip(path.steps, path.steps[1:])
    ]

    # Deduplicate, treating a link and its reverse as the same edge.
    unique: List[Link] = []
    for link in graph.links + added:
        if link not in unique and link.flip() not in unique:
            unique.append(link)

    return Graph(graph.headers, graph.segments, unique, new_paths)


def norm(graph: Graph) -> Graph:
    """Identity transform; emission alone normalizes the representation."""
    return graph


def validate_setup(graph: Graph) -> Graph:
    """Drop 90% of links (seeded-random) to manufacture invalid graphs for
    ``validate`` testing (reference: validate_setup.py)."""
    random.seed(4)
    links = sorted(graph.links)
    links = random.sample(links, int(0.1 * len(links)))
    return Graph(graph.headers, graph.segments, links, graph.paths)


# ---------------------------------------------------------------------------
# inject (reference: slow_odgi inject.py)
# ---------------------------------------------------------------------------


def _walked_segments(graph: Graph, bed: Bed) -> List[Handle]:
    """The steps of ``bed.path`` that fall entirely inside [lo, hi)."""
    pos = 0
    inside: List[Handle] = []
    for step in graph.paths[bed.path].steps:
        length = len(graph.segments[step.name].seq)
        if pos < bed.lo:
            pos += length
            continue
        if pos + length > bed.hi:
            break
        pos += length
        inside.append(step)
    return inside


def _seam_position(
    graph: Graph, path_name: str, offset: int
) -> Optional[Tuple[str, int]]:
    """Locate ``offset`` bp along a path: the segment it lands inside and
    the in-segment cut position (orientation-adjusted), or None if the
    offset already falls on a segment boundary."""
    pos = 0
    for step in graph.paths[path_name].steps:
        if pos == offset:
            return None
        length = len(graph.segments[step.name].seq)
        if pos + length > offset:
            cut = offset - pos
            return step.name, (cut if step.forward else length - cut)
        pos += length
    return None


def _cut_at(graph: Graph, path_name: str, offset: int) -> Graph:
    """Re-segment the graph so that ``offset`` bp along ``path_name``
    falls on a segment seam. Renumbers at most one segment split."""
    seam = _seam_position(graph, path_name, offset)
    if seam is None:
        return graph
    target, cut = seam

    segs: Dict[str, Segment] = {}
    legend: Legend = {}
    for seg in graph.segments.values():
        num = int(seg.name)
        if num < int(target):
            segs[seg.name] = seg
            legend[seg.name] = (num, num + 1)
        elif seg.name == target:
            succ = str(num + 1)
            segs[seg.name] = Segment(seg.name, seg.seq[:cut])
            segs[succ] = Segment(succ, seg.seq[cut:])
            legend[seg.name] = (num, num + 2)
        else:
            succ = str(num + 1)
            segs[succ] = Segment(succ, seg.seq)
            legend[seg.name] = (num + 1, num + 2)

    return Graph(graph.headers, segs, graph.links, renumber_steps(graph, legend))


def inject(graph: Graph, beds: List[Bed]) -> Graph:
    """Add a new named subpath for every BED record, chopping segments at
    the region boundaries when they fall mid-segment."""
    for bed in beds:
        if bed.path not in graph.paths:
            continue  # odgi ignores BEDs over absent paths.
        graph = _cut_at(_cut_at(graph, bed.path, bed.lo), bed.path, bed.hi)
        graph.paths[bed.label] = Path(
            bed.label, _walked_segments(graph, bed), None
        )
    return graph


# ---------------------------------------------------------------------------
# extract (clarity model of the reference's Rust op: ops/extract.rs)
# ---------------------------------------------------------------------------


def extract(
    graph: Graph,
    seg_name: str,
    link_distance: int,
    max_distance_subpaths: int = 300_000,
    num_iterations: int = 6,
) -> Graph:
    """Neighborhood subgraph: segments within ``link_distance`` links of
    the origin (in discovery order), optional gap merging, links among
    included segments, and ``{path}:{lo}-{hi}``-named subpaths."""
    included: Dict[str, int] = {seg_name: 0}
    frontier = [seg_name]
    for _ in range(link_distance):
        next_frontier: List[str] = []
        while frontier:
            seg = frontier.pop()
            for link in graph.links:
                if link.src.name == seg:
                    other = link.dst.name
                elif link.dst.name == seg:
                    other = link.src.name
                else:
                    continue
                if other not in included:
                    included[other] = len(included)
                    next_frontier.append(other)
        frontier = next_frontier

    # Gap merging: adopt the segments of a between-visit gap while the
    # cumulative bp position is still within range.
    for _ in range(num_iterations):
        for path in graph.paths.values():
            gap_start = 0
            in_gap = True
            ignoring = True
            walked = 0
            for i, step in enumerate(path.steps):
                inside = step.name in included
                if in_gap and inside:
                    if not ignoring and walked <= max_distance_subpaths:
                        for gap_step in path.steps[gap_start:i]:
                            if gap_step.name not in included:
                                included[gap_step.name] = len(included)
                    in_gap = False
                    ignoring = False
                elif not in_gap and not inside:
                    gap_start = i
                    in_gap = True
                walked += len(graph.segments[step.name].seq)

    segments = {name: graph.segments[name] for name in included}
    links = [
        lnk
        for lnk in graph.links
        if lnk.src.name in included and lnk.dst.name in included
    ]

    paths: Dict[str, Path] = {}
    for path in graph.paths.values():
        pos = 0
        run_start: Optional[int] = None
        run_pos = 0
        for i, step in enumerate(path.steps + [None]):  # type: ignore[list-item]
            inside = step is not None and step.name in included
            if inside and run_start is None:
                run_start, run_pos = i, pos
            elif not inside and run_start is not None:
                name = f"{path.name}:{run_pos}-{pos}"
                paths[name] = Path(name, path.steps[run_start:i], None)
                run_start = None
            if step is not None:
                pos += len(graph.segments[step.name].seq)

    return Graph(graph.headers, segments, links, paths)


# ---------------------------------------------------------------------------
# Proof obligations (reference: slow_odgi proofs.py)
# ---------------------------------------------------------------------------


def paths_preserved(before: Graph, after: Graph) -> bool:
    """Every path of ``before`` must chart the same nucleotide sequence in
    ``after`` (``after`` may have extra paths)."""
    old = path_sequences(before)
    new = path_sequences(after)
    return all(name in new and new[name] == seq for name, seq in old.items())
