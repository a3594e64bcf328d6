"""The dataflow IR: typed resources and instructions.

Reference semantics: flatgfa-sh/src/ir.rs. Resources live in per-kind
index spaces; byte-stream resources may carry a gzip encoding tag.

The port's copy of the JAX package's pollen_tpu/shell/ir.py, unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

FILE = "file"
STDIN = "stdin"
STDOUT = "stdout"
PIPE = "pipe"
GFA_STORE = "gfa"
MMAP = "mmap"
BED_STORE = "bed"

BYTE_KINDS = (FILE, STDIN, STDOUT, PIPE, MMAP)


@dataclasses.dataclass(frozen=True)
class Resource:
    kind: str
    index: int = 0
    gzip: bool = False

    def encoded(self) -> "Resource":
        assert self.kind in BYTE_KINDS
        return Resource(self.kind, self.index, True)

    def label(self, prog: "Program") -> str:
        if self.kind == FILE:
            base = f'"{prog.file_names[self.index]}"'
        elif self.kind in (STDIN, STDOUT):
            base = self.kind
        else:
            base = f"{self.kind}-{self.index}"
        return f"gz {base}" if self.gzip else base


STDIN_R = Resource(STDIN)
STDOUT_R = Resource(STDOUT)


@dataclasses.dataclass
class Instr:
    inputs: List[Resource]
    output: Resource
    op: str
    args: Dict = dataclasses.field(default_factory=dict)

    def render(self, prog: "Program") -> str:
        ins = ", ".join(r.label(prog) for r in self.inputs)
        extra = "".join(
            f", {k}={v}" for k, v in sorted(self.args.items()) if v is not None
        )
        return f"{self.op}({ins}{extra}) -> {self.output.label(prog)}"


# Op names.
PATHS = "paths"
NODE_DEPTH = "node-depth"
PATH_DEPTH = "path-depth"
PATH_LENGTH = "path-length"
EXEC = "exec"
PARSE_GFA = "parse-gfa"
MAP_FILE = "map-file"
PARSE_BED = "parse-bed"
MAKE_WINDOWS = "make-windows"
ODGI_VIEW = "odgi-view"
INTERVAL_DEPTH = "interval-depth"
GZIP_DECOMPRESS = "gzip-decompress"


class Program:
    def __init__(self) -> None:
        self.instrs: List[Instr] = []
        self.file_names: List[str] = []
        self._file_ids: Dict[str, int] = {}
        self._counts: Dict[str, int] = {}

    # -- construction ------------------------------------------------------

    def file(self, name: str) -> Resource:
        if name not in self._file_ids:
            self._file_ids[name] = len(self.file_names)
            self.file_names.append(name)
        return Resource(FILE, self._file_ids[name])

    def fresh(self, kind: str) -> Resource:
        idx = self._counts.get(kind, 0)
        self._counts[kind] = idx + 1
        return Resource(kind, idx)

    def instr(
        self,
        inputs: List[Resource],
        output: Resource,
        op: str,
        **args,
    ) -> None:
        self.instrs.append(Instr(list(inputs), output, op, args))

    # -- derived loads (reference: builder.rs load_gfa/load_bed) -----------

    def load_gfa(self, src: Resource) -> Resource:
        if src.kind == FILE:
            name = self.file_names[src.index]
            if name.endswith(".flatgfa"):
                out = self.fresh(MMAP)
                self.instr([src], out, MAP_FILE)
                return out
            if name.endswith(".og"):
                pipe = self.fresh(PIPE)
                self.instr([src], pipe, ODGI_VIEW)
                return self.load_gfa(pipe)
        if src.kind in (PIPE, STDIN, FILE):
            src = self.maybe_decompress(src)
            out = self.fresh(GFA_STORE)
            self.instr([src], out, PARSE_GFA)
            return out
        raise ValueError(f"cannot read GFA from {src.kind}")

    def load_bed(self, src: Resource) -> Resource:
        if src.kind in (PIPE, STDIN, FILE):
            src = self.maybe_decompress(src)
            out = self.fresh(BED_STORE)
            self.instr([src], out, PARSE_BED)
            return out
        raise ValueError(f"cannot read BED from {src.kind}")

    def maybe_decompress(self, src: Resource) -> Resource:
        if src.kind == FILE and self.file_names[src.index].endswith(".gz"):
            pipe = self.fresh(PIPE)
            self.instr([src], pipe, GZIP_DECOMPRESS)
            return pipe
        return src

    # -- rewriting ---------------------------------------------------------

    def replace_resource(self, old: Resource, new: Resource) -> None:
        for instr in self.instrs:
            instr.inputs = [new if r == old else r for r in instr.inputs]
            if instr.output == old:
                instr.output = new

    def remove(self, indices: List[int]) -> None:
        drop = set(indices)
        self.instrs = [
            ins for i, ins in enumerate(self.instrs) if i not in drop
        ]

    def def_use(self) -> Tuple[List[List[Optional[int]]], List[List[int]]]:
        """For each instruction: the defining instruction index of each
        input, and the indices of instructions using its output."""
        last_def: Dict[Resource, int] = {}
        defs: List[List[Optional[int]]] = []
        uses: List[List[int]] = [[] for _ in self.instrs]
        for i, instr in enumerate(self.instrs):
            row: List[Optional[int]] = []
            for src in self.inputs_of(i):
                d = last_def.get(src)
                row.append(d)
                if d is not None:
                    uses[d].append(i)
            defs.append(row)
            last_def[instr.output] = i
        return defs, uses

    def inputs_of(self, i: int) -> List[Resource]:
        return self.instrs[i].inputs

    def render(self) -> str:
        return "".join(ins.render(self) + "\n" for ins in self.instrs)
