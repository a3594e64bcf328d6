"""``exine-torch``: the command line of the fixed-dimension depth accelerator.

The port's copy of pollen_tpu/accel/__main__.py (``exine-tpu``).
Mirrors the reference's ``exine depth`` surface (reference:
pollen_py/pollen/depth/main.py): generate the JSON memories, run the
accelerator, and/or convert outputs to the odgi-style TSV.

    exine-torch depth -a -r graph.gfa        # end to end, auto dims
    exine-torch depth --gen graph.gfa        # emit the JSON memories
    exine-torch json graph.gfa               # generic graph JSON

``--device cuda|cpu`` (default ``cuda``) picks where the PE array runs;
a ``cuda`` run without a card is an error. Unlike the reference, no
graph size sends a run to the CPU on its own.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..device import resolve_device
from ..flatgfa import parse_gfa_file
from .datagen import (
    accel_dims,
    depth_json,
    depth_table_from_outputs,
    graph_json,
    parse_depth_json,
)
from .kernel import run_accel


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="exine-torch")
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where the PE array runs (default: cuda; without a CUDA "
        "device this is an error)",
    )
    sub = parser.add_subparsers(dest="command", metavar="COMMAND")

    cmd = sub.add_parser("depth", help="fixed-dimension depth accelerator")
    cmd.add_argument("graph")
    cmd.add_argument(
        "-a", "--auto", action="store_true", help="auto-size dimensions"
    )
    cmd.add_argument("-n", "--max-nodes", type=int)
    cmd.add_argument("-e", "--max-steps", type=int)
    cmd.add_argument("-p", "--max-paths", type=int)
    cmd.add_argument("-s", "--subset-paths", help="file listing paths")
    cmd.add_argument(
        "--gen",
        action="store_true",
        help="emit the JSON memories instead of running",
    )
    cmd.add_argument(
        "-r",
        "--run",
        action="store_true",
        help="run the accelerator and print the depth table",
    )

    cmd = sub.add_parser("json", help="generic graph JSON")
    cmd.add_argument("graph")

    return parser


def main(argv: Optional[List[str]] = None) -> None:
    try:
        _main(argv)
    except BrokenPipeError:
        raise SystemExit(0)
    except (OSError, ValueError, KeyError, RuntimeError) as exc:
        print(f"exine-torch: error: {exc}", file=sys.stderr)
        raise SystemExit(1)


def _main(argv: Optional[List[str]]) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.command:
        parser.print_help()
        raise SystemExit(1)
    device = resolve_device(args.device)

    g = parse_gfa_file(args.graph)

    if args.command == "json":
        print(graph_json(g))
        return

    subset = None
    if args.subset_paths:
        with open(args.subset_paths, "r", encoding="utf-8") as f:
            subset = [ln.strip() for ln in f if ln.strip()]

    if args.auto or not (args.max_nodes and args.max_steps and args.max_paths):
        max_n, max_e, max_p = accel_dims(g)
    if args.max_nodes:
        max_n = args.max_nodes
    if args.max_steps:
        max_e = args.max_steps
    if args.max_paths:
        max_p = args.max_paths

    memories = depth_json(g, max_n, max_e, max_p, subset)
    if args.gen:
        print(memories)
        return

    path_ids, consider = parse_depth_json(memories)
    depth, uniq = run_accel(path_ids, consider, device)
    sys.stdout.write(depth_table_from_outputs(depth, uniq))


if __name__ == "__main__":
    main()
