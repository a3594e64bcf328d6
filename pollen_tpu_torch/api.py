"""Object-style Python API over the flat arena.

The port's copy of the JAX package's object API (pollen_tpu/api.py),
which mirrors the reference's ``flatgfa-py`` surface (reference:
flatgfa-py/flatgfa.pyi and src/lib.rs): ``parse`` / ``parse_bytes`` /
``load`` build a :class:`FlatGFA` whose ``segments`` / ``paths`` /
``links`` attributes are sliceable, iterable, find-able list views over
the underlying arrays — no per-entity copies; ``sequence()`` is the
only accessor that materializes data.

One difference: each of them takes ``device`` ("cuda", the default,
or "cpu"), where :meth:`FlatGFA.device` builds the index. There is no
size-based routing to the CPU: without a CUDA card the default is an
error, raised when the index is first built.

>>> g = parse("graph.gfa", device="cpu")
>>> g.paths[0].name, len(g.paths[0])
>>> [h.segment.name for h in g.paths[0]]
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Union

import numpy as np

from . import flatgfa as _fg
from .emit import emit_gfa
from .fileformat import load_flatgfa, save_flatgfa


class Segment:
    def __init__(self, g: "FlatGFA", seg_id: int):
        self._g = g
        self.id = seg_id

    @property
    def name(self) -> int:
        return int(self._g._a.seg_name[self.id])

    def sequence(self) -> bytes:
        return self._g._a.seg_sequence(self.id)

    def __len__(self) -> int:
        lo, hi = self._g._a.seg_seq[self.id]
        return int(hi - lo)

    def __repr__(self) -> str:
        return f"<Segment {self.name}>"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Segment)
            and other._g is self._g
            and other.id == self.id
        )

    def __hash__(self) -> int:
        return hash(("seg", id(self._g), self.id))


class Handle:
    def __init__(self, g: "FlatGFA", packed: int):
        self._g = g
        self._packed = int(packed)

    @property
    def seg_id(self) -> int:
        return self._packed >> 1

    @property
    def segment(self) -> Segment:
        return Segment(self._g, self.seg_id)

    @property
    def is_forward(self) -> bool:
        return (self._packed & 1) == 0

    def __repr__(self) -> str:
        ori = "+" if self.is_forward else "-"
        return f"<Handle {self.segment.name}{ori}>"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Handle)
            and other._g is self._g
            and other._packed == self._packed
        )

    def __hash__(self) -> int:
        return hash(("handle", id(self._g), self._packed))


class StepList:
    """A (slice of a) path's steps."""

    def __init__(self, g: "FlatGFA", lo: int, hi: int):
        self._g = g
        self._lo = lo
        self._hi = hi

    def __len__(self) -> int:
        return self._hi - self._lo

    def __iter__(self) -> Iterator[Handle]:
        steps = self._g._a.steps
        for i in range(self._lo, self._hi):
            yield Handle(self._g, int(steps[i]))

    def __getitem__(self, idx: Union[int, slice]):
        if isinstance(idx, slice):
            lo, hi, stride = idx.indices(len(self))
            if stride != 1:
                raise ValueError("only unit-stride slices are supported")
            return StepList(self._g, self._lo + lo, self._lo + hi)
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        return Handle(self._g, int(self._g._a.steps[self._lo + idx]))


class Path:
    def __init__(self, g: "FlatGFA", path_id: int):
        self._g = g
        self.id = path_id

    @property
    def name(self) -> bytes:
        return self._g._a.path_name_bytes(self.id)

    def _steps(self) -> StepList:
        lo, hi = self._g._a.path_steps[self.id]
        return StepList(self._g, int(lo), int(hi))

    def __len__(self) -> int:
        return len(self._steps())

    def __iter__(self) -> Iterator[Handle]:
        return iter(self._steps())

    def __getitem__(self, idx):
        return self._steps()[idx]

    def __repr__(self) -> str:
        return f"<Path {self.name.decode()}>"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Path)
            and other._g is self._g
            and other.id == self.id
        )

    def __hash__(self) -> int:
        return hash(("path", id(self._g), self.id))


class Link:
    def __init__(self, g: "FlatGFA", link_id: int):
        self._g = g
        self.id = link_id

    @property
    def from_(self) -> Handle:
        return Handle(self._g, int(self._g._a.link_from[self.id]))

    @property
    def to(self) -> Handle:
        return Handle(self._g, int(self._g._a.link_to[self.id]))

    def __repr__(self) -> str:
        return f"<Link {self.from_!r} -> {self.to!r}>"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Link)
            and other._g is self._g
            and other.id == self.id
        )

    def __hash__(self) -> int:
        return hash(("link", id(self._g), self.id))


class _ListView:
    _entity = None

    def __init__(self, g: "FlatGFA", lo: int, hi: int):
        self._g = g
        self._lo = lo
        self._hi = hi

    def __len__(self) -> int:
        return self._hi - self._lo

    def __iter__(self):
        for i in range(self._lo, self._hi):
            yield self._entity(self._g, i)

    def __getitem__(self, idx: Union[int, slice]):
        if isinstance(idx, slice):
            lo, hi, stride = idx.indices(len(self))
            if stride != 1:
                raise ValueError("only unit-stride slices are supported")
            return type(self)(self._g, self._lo + lo, self._lo + hi)
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        return self._entity(self._g, self._lo + idx)


class SegmentList(_ListView):
    _entity = Segment

    def find(self, name: int) -> Optional[Segment]:
        hits = np.flatnonzero(self._g._a.seg_name == name)
        return Segment(self._g, int(hits[0])) if hits.size else None


class PathList(_ListView):
    _entity = Path

    def find(self, name: bytes) -> Optional[Path]:
        pid = self._g._a.path_id_by_name(name)
        return Path(self._g, pid) if pid is not None else None


class LinkList(_ListView):
    _entity = Link


class FlatGFA:
    """A variation graph (object facade over :class:`GraphArrays`)."""

    def __init__(self, arrays: _fg.GraphArrays, *, device="cuda"):
        self._a = arrays
        self.torch_device = device
        self._dg = None

    @property
    def arrays(self) -> _fg.GraphArrays:
        """The underlying flat arena (the tensor-facing interface)."""
        return self._a

    def device(self):
        """The device-resident index on ``torch_device`` (built lazily,
        cached); a CUDA device with no card raises."""
        if self._dg is None:
            from .device import build_graph

            self._dg = build_graph(self._a, self.torch_device)
        return self._dg

    @property
    def segments(self) -> SegmentList:
        return SegmentList(self, 0, self._a.num_segments)

    @property
    def paths(self) -> PathList:
        return PathList(self, 0, self._a.num_paths)

    @property
    def links(self) -> LinkList:
        return LinkList(self, 0, self._a.num_links)

    def __str__(self) -> str:
        return emit_gfa(self._a, order="preserved")

    def write_gfa(self, filename: str) -> None:
        from .emit import emit_gfa_to_file

        emit_gfa_to_file(self._a, filename)

    def write_flatgfa(self, filename: str) -> None:
        save_flatgfa(filename, self._a)

    def all_reads(self, gaf: str) -> "GAFParser":
        """Parse a GAF file against this graph; iterate GAFLine objects
        (reference surface: flatgfa-py all_reads/GAFParser)."""
        from .ops.gaf import chunk_events, parse_gaf_file

        reads = parse_gaf_file(gaf, self._a)
        _, kind, a, b = chunk_events(self._a, self.device(), reads)
        return GAFParser(self, reads, kind, a, b)

    def print_gaf_lookup(self, gaf: str) -> None:
        import sys

        from .ops.gaf import parse_gaf_file, run_gaf_lookup

        reads = parse_gaf_file(gaf, self._a)
        sys.stdout.write(run_gaf_lookup(self._a, self.device(), reads))

    def make_pangenotype_matrix(self, gaf_files: List[str]) -> List[List[bool]]:
        from .ops.gaf import pangenotype_matrix

        return pangenotype_matrix(self._a, gaf_files).tolist()


class ChunkEvent:
    """One read step's coverage of a segment.

    ``range`` follows the reference's quirky encoding (flatgfa-py
    lib.rs:527-536): skipped -> (1, 0), fully covered ->
    (0, len - 1), partial -> the clipped [start, end) offsets.
    """

    def __init__(self, g: FlatGFA, packed: int, kind: int, a: int, b: int):
        self._g = g
        self._packed = packed
        self._kind = kind
        self._a = a
        self._b = b

    @property
    def handle(self) -> Handle:
        return Handle(self._g, self._packed)

    @property
    def range(self):
        from .ops.gaf import KIND_ALL, KIND_NONE

        if self._kind == KIND_NONE:
            return (1, 0)
        if self._kind == KIND_ALL:
            return (0, len(self.handle.segment) - 1)
        return (self._a, self._b)

    def sequence(self) -> str:
        from .ops.gaf import KIND_ALL, KIND_NONE, _revcomp

        if self._kind == KIND_NONE:
            return ""
        seq = self.handle.segment.sequence()
        if not self.handle.is_forward:
            seq = _revcomp(seq)
        if self._kind != KIND_ALL:
            seq = seq[self._a : self._b]
        return seq.decode("ascii")

    def _seg_text(self, index: int) -> str:
        from .ops.gaf import KIND_ALL, KIND_NONE

        name = self.handle.segment.name
        ori = "+" if self.handle.is_forward else "-"
        if self._kind == KIND_NONE:
            return f"{index}: (skipped)"
        if self._kind == KIND_ALL:
            return f"{index}: {name}{ori}, {len(self.handle.segment)}bp"
        return f"{index}: {name}{ori}, {self._a}-{self._b}bp"


class GAFLine:
    def __init__(self, g: FlatGFA, name: str, chunks: List[ChunkEvent]):
        self._g = g
        self.name = name
        self.chunks = chunks

    def __iter__(self) -> Iterator[ChunkEvent]:
        return iter(self.chunks)

    def sequence(self) -> str:
        return "".join(c.sequence() for c in self.chunks)

    def segment_ranges(self) -> str:
        return "".join(
            "\n" + c._seg_text(i) for i, c in enumerate(self.chunks)
        )


class GAFParser:
    """Iterable of a GAF file's reads (chunking precomputed in one
    batched device pass; iteration is pure object assembly)."""

    def __init__(self, g: FlatGFA, reads, kind, a, b):
        self._g = g
        self._reads = reads
        self._kind = kind
        self._a = a
        self._b = b

    def __iter__(self) -> Iterator[GAFLine]:
        for r in range(self._reads.num_reads):
            lo, hi = self._reads.read_bounds[r], self._reads.read_bounds[r + 1]
            chunks = [
                ChunkEvent(
                    self._g,
                    int(self._reads.steps[i]),
                    int(self._kind[i]),
                    int(self._a[i]),
                    int(self._b[i]),
                )
                for i in range(lo, hi)
            ]
            yield GAFLine(self._g, self._reads.read_name(r).decode(), chunks)


def parse(filename: str, *, device="cuda") -> FlatGFA:
    """Parse a GFA text file."""
    return FlatGFA(_fg.parse_gfa_file(filename), device=device)


def parse_bytes(gfa: bytes, *, device="cuda") -> FlatGFA:
    """Parse GFA text from a byte string."""
    return FlatGFA(_fg.parse_gfa(gfa), device=device)


def load(filename: str, *, device="cuda") -> FlatGFA:
    """mmap a binary FlatGFA file (zero-copy)."""
    return FlatGFA(load_flatgfa(filename), device=device)
