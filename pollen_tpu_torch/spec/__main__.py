"""Command-line front end for the executable spec.

Mirrors the reference's ``slow_odgi`` CLI surface (reference:
slow_odgi/slow_odgi/__main__.py) so the same golden-test harness drives
both: ``python -m pollen_tpu_torch.spec <command> [graph] [options]``
or ``pollen-spec-torch``.
"""

from __future__ import annotations

import argparse
import io
import sys
from typing import List, Optional, TextIO

from . import commands
from .model import Bed, Graph


def _read_lines(filename: str) -> List[str]:
    with open(filename, "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def _load_beds(filename: str) -> List[Bed]:
    return [Bed.parse(ln) for ln in _read_lines(filename)]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="pollen-spec-torch")
    sub = parser.add_subparsers(dest="command", metavar="COMMAND")

    cmd = sub.add_parser("chop", help="shorten segments to a max length")
    cmd.add_argument("-n", required=True, help="max segment length")

    sub.add_parser("crush", help="squash runs of N")
    sub.add_parser("degree", help="per-segment degree table")

    cmd = sub.add_parser("depth", help="per-segment depth table")
    cmd.add_argument("--paths", help="file listing paths to count")

    sub.add_parser("flatten", help="FASTA + BED rendering")
    sub.add_parser("flip", help="orient paths forward")

    cmd = sub.add_parser("inject", help="add BED regions as new paths")
    cmd.add_argument("--bed", required=True, help="BED file of regions")

    sub.add_parser("matrix", help="sparse matrix rendering")

    cmd = sub.add_parser("overlap", help="which paths touch these paths")
    cmd.add_argument("--paths", required=True, help="file listing paths")

    sub.add_parser("paths", help="list path names")

    cmd = sub.add_parser("somepaths", help="list paths, dropping some")
    cmd.add_argument("--drop", type=int, default=0, metavar="PCT")

    sub.add_parser("validate", help="check links support paths")

    cmd = sub.add_parser("norm", help="normalize representation")
    cmd.add_argument("--nl", action="store_true", help="omit links")

    sub.add_parser("inject_setup")
    sub.add_parser("validate_setup")

    for cmd in sub.choices.values():
        cmd.add_argument("graph", nargs="?", metavar="GRAPH")

    return parser


def run(args: argparse.Namespace, out: TextIO) -> None:
    if args.graph:
        with open(args.graph, "r", encoding="utf-8") as f:
            graph = Graph.parse(f)
    else:
        graph = Graph.parse(
            io.TextIOWrapper(sys.stdin.buffer, encoding="utf-8")
        )

    name = args.command
    result: Optional[Graph] = None
    include_links = True

    if name == "chop":
        result = commands.chop(graph, int(args.n))
        include_links = False
    elif name == "crush":
        result = commands.crush(graph)
    elif name == "flip":
        result = commands.flip(graph)
    elif name == "inject":
        result = commands.inject(graph, _load_beds(args.bed))
        include_links = False
    elif name == "norm":
        result = commands.norm(graph)
        include_links = not args.nl
    elif name == "validate_setup":
        result = commands.validate_setup(graph)
    elif name == "degree":
        commands.degree(graph, out)
    elif name == "depth":
        subset = _read_lines(args.paths) if args.paths else None
        commands.depth(graph, out, subset)
    elif name == "flatten":
        commands.flatten(graph, out, f"{args.graph[:-4]}.og")
    elif name == "matrix":
        commands.matrix(graph, out)
    elif name == "overlap":
        commands.overlap(graph, out, _read_lines(args.paths))
    elif name == "paths":
        commands.paths(graph, out)
    elif name == "somepaths":
        commands.some_paths(graph, out, args.drop)
    elif name == "validate":
        commands.validate(graph, out)
    elif name == "inject_setup":
        commands.inject_setup(graph, out)
    else:
        raise SystemExit(f"unknown command {name!r}")

    if result is not None:
        result.emit(out, include_links)
        if name in ("chop", "inject"):
            assert commands.paths_preserved(graph, result)


def main() -> None:
    parser = build_parser()
    args = parser.parse_args()
    if not args.command:
        parser.print_help()
        raise SystemExit(1)
    try:
        run(args, sys.stdout)
    except BrokenPipeError:
        raise SystemExit(0)
    except (OSError, ValueError, KeyError) as exc:
        print(f"pollen-spec-torch: error: {exc}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
