"""IR evaluator: in-process engine calls plus real subprocesses.

Reference semantics: flatgfa-sh/src/eval. Streams (stdin, stdout,
pipes, files) carry bytes; graph/BED resources carry in-memory engine
structures. Pipe resources are buffered in memory (the reference uses
OS pipes; buffering trades streaming for deadlock freedom and makes
subprocess stages simple ``subprocess.run`` calls — exit status is
ignored, as in the reference).

The port's copy of the JAX package's pollen_tpu/shell/evaluate.py over
the port's modules. The index is built on the device ``run_program`` is
given ("cuda" by default; without a card that is an error), with no
size-based routing to the CPU.
"""

from __future__ import annotations

import gzip as gzip_mod
import subprocess
import sys
from typing import Dict, Optional

import numpy as np
import torch

from .. import flatgfa as fg
from ..bed import FlatBed, parse_bed, windows_bed
from ..device import build_graph, resolve_device
from ..fileformat import load_flatgfa
from ..ops import depth as depth_op
from ..ops.window_depth import interval_depth, interval_depth_table
from . import ir
from .ir import Program, Resource


class Env:
    def __init__(
        self, prog: Program, stdin: bytes, torch_device: torch.device
    ) -> None:
        self.prog = prog
        self.stdin = stdin
        self.torch_device = torch_device
        self.stdout = bytearray()
        self.pipes: Dict[int, bytes] = {}
        self.gfa: Dict[int, fg.GraphArrays] = {}
        self.mmaps: Dict[int, fg.GraphArrays] = {}
        self.beds: Dict[int, FlatBed] = {}
        self._device_cache: Dict[int, object] = {}

    # -- byte streams ------------------------------------------------------

    def read_bytes(self, r: Resource) -> bytes:
        if r.kind == ir.FILE:
            with open(self.prog.file_names[r.index], "rb") as f:
                data = f.read()
        elif r.kind == ir.STDIN:
            data = self.stdin
        elif r.kind == ir.PIPE:
            data = self.pipes.get(r.index, b"")
        else:
            raise ValueError(f"not a byte source: {r.kind}")
        if r.gzip:
            data = gzip_mod.decompress(data)
        return data

    def write_bytes(self, r: Resource, data: bytes) -> None:
        if r.kind == ir.STDOUT:
            self.stdout.extend(data)
        elif r.kind == ir.PIPE:
            self.pipes[r.index] = self.pipes.get(r.index, b"") + data
        elif r.kind == ir.FILE:
            with open(self.prog.file_names[r.index], "wb") as f:
                f.write(data)
        else:
            raise ValueError(f"not a byte sink: {r.kind}")

    # -- graphs ------------------------------------------------------------

    def graph(self, r: Resource) -> fg.GraphArrays:
        if r.kind == ir.GFA_STORE:
            return self.gfa[r.index]
        if r.kind == ir.MMAP:
            return self.mmaps[r.index]
        raise ValueError(f"not a graph resource: {r.kind}")

    def device(self, r: Resource):
        key = (r.kind, r.index)
        if key not in self._device_cache:
            # No flash op does masked subset-depth, so never build the
            # crossing-matrix / tiered-ELL indexes (measured: halves
            # the 8M-step ingest).
            self._device_cache[key] = build_graph(
                self.graph(r), self.torch_device, cross_matrix="never"
            )
        return self._device_cache[key]


def _path_depth_bed(g: fg.GraphArrays, dg, path: Optional[str]) -> FlatBed:
    lengths, _ = depth_op.path_depth(dg)
    lengths = lengths.cpu().numpy()
    ids = range(g.num_paths)
    if path is not None:
        pid = g.path_id_by_name(path.encode())
        if pid is None:
            raise KeyError(f"no such path: {path}")
        ids = [pid]
    names = [g.path_name_bytes(i) for i in ids]
    blob = b"".join(names)
    lens = np.array([len(n) for n in names], dtype=np.int64)
    ends = np.cumsum(lens) if lens.size else np.zeros(0, np.int64)
    return FlatBed(
        name_data=np.frombuffer(blob, dtype=np.uint8).copy()
        if blob
        else np.zeros(0, np.uint8),
        name_span=np.stack([ends - lens, ends], axis=1).astype(np.uint32)
        if lens.size
        else np.zeros((0, 2), np.uint32),
        start=np.zeros(len(names), np.uint64),
        end=np.array([lengths[i] for i in ids], dtype=np.uint64),
    )


def _bed_text(bed: FlatBed) -> str:
    return "".join(
        f"{bed.entry_name(i).decode()}\t{int(bed.start[i])}\t{int(bed.end[i])}\n"
        for i in range(bed.num_entries)
    )


def _eval_instr(env: Env, instr: ir.Instr) -> None:
    op = instr.op
    out = instr.output

    if op == ir.PARSE_GFA:
        env.gfa[out.index] = fg.parse_gfa(env.read_bytes(instr.inputs[0]))
    elif op == ir.MAP_FILE:
        name = env.prog.file_names[instr.inputs[0].index]
        env.mmaps[out.index] = load_flatgfa(name)
    elif op == ir.PARSE_BED:
        env.beds[out.index] = parse_bed(env.read_bytes(instr.inputs[0]))
    elif op == ir.PATHS:
        g = env.graph(instr.inputs[0])
        env.write_bytes(
            out, b"".join(n + b"\n" for n in g.path_names())
        )
    elif op == ir.NODE_DEPTH:
        g = env.graph(instr.inputs[0])
        env.write_bytes(
            out, depth_op.run_seg_depth(g, env.device(instr.inputs[0])).encode()
        )
    elif op == ir.PATH_DEPTH:
        g = env.graph(instr.inputs[0])
        dg = env.device(instr.inputs[0])
        path = instr.args.get("path")
        if out.kind == ir.BED_STORE:
            env.beds[out.index] = _path_depth_bed(g, dg, path)
        else:
            paths = [path] if path else None
            env.write_bytes(
                out, depth_op.run_path_depth(g, dg, paths).encode()
            )
    elif op == ir.PATH_LENGTH:
        g = env.graph(instr.inputs[0])
        dg = env.device(instr.inputs[0])
        env.beds[out.index] = _path_depth_bed(g, dg, instr.args["path"])
    elif op == ir.MAKE_WINDOWS:
        src = env.beds[instr.inputs[0].index]
        size = instr.args["size"]
        pieces = [
            windows_bed(
                src.entry_name(i), int(src.start[i]), int(src.end[i]), size
            )
            for i in range(src.num_entries)
        ]
        merged = _concat_beds(pieces)
        if out.kind == ir.BED_STORE:
            env.beds[out.index] = merged
        else:
            env.write_bytes(out, _bed_text(merged).encode())
    elif op == ir.INTERVAL_DEPTH:
        g = env.graph(instr.inputs[0])
        dg = env.device(instr.inputs[0])
        bed = env.beds[instr.inputs[1].index]
        pid = g.path_id_by_name(bed.entry_name(0))
        if pid is None:
            raise KeyError("path not found in graph")
        depths = interval_depth(g, dg, pid, bed)
        env.write_bytes(
            out,
            (
                "#path\tstart\tend\tmean.depth\n"
                + interval_depth_table(bed, depths)
            ).encode(),
        )
    elif op == ir.GZIP_DECOMPRESS:
        env.write_bytes(out, gzip_mod.decompress(env.read_bytes(instr.inputs[0])))
    elif op == ir.ODGI_VIEW:
        name = env.prog.file_names[instr.inputs[0].index]
        _run_cmd(env, "odgi", ["view", "-g", "-i", name], None, out)
    elif op == ir.EXEC:
        data = env.read_bytes(instr.inputs[0]) if instr.inputs else b""
        _run_cmd(env, instr.args["command"], list(instr.args["args"]), data, out)
    else:
        raise ValueError(f"unknown op {op!r}")


def _concat_beds(pieces) -> FlatBed:
    if not pieces:
        return parse_bed(b"")
    name_data = np.concatenate([p.name_data for p in pieces])
    offs = np.cumsum([0] + [p.name_data.shape[0] for p in pieces[:-1]])
    name_span = np.concatenate(
        [p.name_span + np.uint32(off) for p, off in zip(pieces, offs)]
    )
    return FlatBed(
        name_data=name_data,
        name_span=name_span.astype(np.uint32),
        start=np.concatenate([p.start for p in pieces]),
        end=np.concatenate([p.end for p in pieces]),
    )


def _run_cmd(env: Env, command, args, stdin: Optional[bytes], out: Resource):
    try:
        result = subprocess.run(
            [command, *args],
            input=stdin,
            capture_output=True,
            check=False,  # the reference ignores exit status too
        )
        env.write_bytes(out, result.stdout)
        sys.stderr.buffer.write(result.stderr)
    except FileNotFoundError:
        print(f"flash-torch: command not found: {command}", file=sys.stderr)


def run_program(prog: Program, stdin: bytes = b"", device="cuda") -> bytes:
    """Evaluate a program, its graph indexes on ``device``; returns the
    bytes written to stdout."""
    env = Env(prog, stdin, resolve_device(device))
    for instr in prog.instrs:
        _eval_instr(env, instr)
    return bytes(env.stdout)
