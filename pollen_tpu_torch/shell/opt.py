"""IR optimizer: the five flash passes plus gzip fusion.

Reference semantics: flatgfa-sh/src/opt.rs —

1. ``parse-gfa("x.gfa")`` -> ``map-file("x.flatgfa")`` when the binary
   exists on disk.
2. ``odgi-view("x.og") | parse-gfa`` -> a FlatGFA map or direct text
   parse, eliminating the odgi subprocess.
3. BED file round-trip elision: a producer writing a BED file consumed
   only by ``parse-bed`` produces the in-memory store directly.
4. ``path-depth`` -> ``path-length`` when only window generation
   consumes it (the depth numbers are discarded).
5. Duplicate ``map-file`` reads of one file collapse to a single load.
6. ``gzip-decompress | parse-gfa`` fuses into an encoded-stream parse.

The port's copy of the JAX package's pollen_tpu/shell/opt.py, unchanged.
"""

from __future__ import annotations

import os
from typing import List

from . import ir
from .ir import Program


def optimize(prog: Program) -> Program:
    opt_gfa_parse(prog)
    opt_og_parse(prog)
    skip_bed_files(prog)
    simplify_depth_to_length(prog)
    dedup_files(prog)
    opt_decompress(prog)
    return prog


def _replace_with_flat(prog: Program, stem: str, idx: int) -> bool:
    flat = f"{stem}.flatgfa"
    if not os.path.exists(flat):
        return False
    old_out = prog.instrs[idx].output
    new_out = prog.fresh(ir.MMAP)
    prog.instrs[idx].inputs = [prog.file(flat)]
    prog.instrs[idx].op = ir.MAP_FILE
    prog.instrs[idx].args = {}
    prog.instrs[idx].output = new_out
    prog.replace_resource(old_out, new_out)
    return True


def opt_gfa_parse(prog: Program) -> None:
    for idx, instr in enumerate(prog.instrs):
        if instr.op != ir.PARSE_GFA or instr.inputs[0].kind != ir.FILE:
            continue
        name = prog.file_names[instr.inputs[0].index]
        if name.endswith(".gfa"):
            _replace_with_flat(prog, name[: -len(".gfa")], idx)


def opt_og_parse(prog: Program) -> None:
    defs, _ = prog.def_use()
    drop: List[int] = []
    for idx, instr in enumerate(prog.instrs):
        if instr.op != ir.PARSE_GFA or not defs[idx] or defs[idx][0] is None:
            continue
        view_idx = defs[idx][0]
        if prog.instrs[view_idx].op != ir.ODGI_VIEW:
            continue
        og_name = prog.file_names[prog.instrs[view_idx].inputs[0].index]
        stem = og_name[: -len(".og")]
        if _replace_with_flat(prog, stem, idx):
            drop.append(view_idx)
            continue
        text = f"{stem}.gfa"
        if os.path.exists(text):
            prog.instrs[idx].inputs = [prog.file(text)]
            drop.append(view_idx)
    prog.remove(drop)


_BED_PRODUCERS = (ir.MAKE_WINDOWS, ir.PATH_DEPTH)


def skip_bed_files(prog: Program) -> None:
    defs, uses = prog.def_use()
    drop: List[int] = []
    for idx, instr in enumerate(prog.instrs):
        if instr.op != ir.PARSE_BED or not defs[idx] or defs[idx][0] is None:
            continue
        def_idx = defs[idx][0]
        if len(uses[def_idx]) != 1:
            continue
        if prog.instrs[def_idx].op not in _BED_PRODUCERS:
            continue
        prog.instrs[def_idx].output = instr.output
        drop.append(idx)
    prog.remove(drop)


def simplify_depth_to_length(prog: Program) -> None:
    defs, uses = prog.def_use()
    for idx, instr in enumerate(prog.instrs):
        if instr.op != ir.MAKE_WINDOWS or not defs[idx] or defs[idx][0] is None:
            continue
        def_idx = defs[idx][0]
        if len(uses[def_idx]) != 1:
            continue
        producer = prog.instrs[def_idx]
        if producer.op == ir.PATH_DEPTH and producer.args.get("path"):
            producer.op = ir.PATH_LENGTH


def dedup_files(prog: Program) -> None:
    seen: dict = {}
    drop: List[int] = []
    replacements = []
    for idx, instr in enumerate(prog.instrs):
        if instr.op == ir.MAP_FILE:
            key = instr.inputs[0]
            if key in seen:
                replacements.append((instr.output, seen[key]))
                drop.append(idx)
            else:
                seen[key] = instr.output
        if instr.output.kind == ir.FILE:
            seen.pop(instr.output, None)
    for old, new in replacements:
        prog.replace_resource(old, new)
    prog.remove(drop)


def opt_decompress(prog: Program) -> None:
    defs, uses = prog.def_use()
    drop: List[int] = []
    for idx, instr in enumerate(prog.instrs):
        if instr.op != ir.GZIP_DECOMPRESS:
            continue
        if not uses[idx] or any(
            prog.instrs[u].op != ir.PARSE_GFA for u in uses[idx]
        ):
            continue
        prog.replace_resource(instr.output, instr.inputs[0].encoded())
        drop.append(idx)
    prog.remove(drop)
