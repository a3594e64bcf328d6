"""``fgfa-torch``: the command-line tool of the PyTorch / CUDA port.

The grammar is the port's own copy of the reference CLI's
(``pollen_tpu/cli.py`` ``build_parser``, ``_load``, ``_read_lines`` and
``_needs_masked_index``), every flag and default kept, so that every
command line means what it means to ``fgfa-tpu``; ``--device`` is added.
Served so far: ``depth`` (path depth, ``-r``), ``depth -d``,
``depth -d -s FILE``, ``depth -S FILE`` (one subset per line, all
answered in one batched device pass) and ``serve``, which answers depth
requests over one resident graph with the reference's framing
(``##end\\tok`` or ``##end\\terror\\t<message>`` after each response).
Every other command, and ``-o``/``-O`` output on any command or serve
request, exits with "not ported yet".

``--device cuda|cpu`` (default ``cuda``) picks where the index lives and
the queries run. A ``cuda`` run without a card is an error.
"""

from __future__ import annotations

import argparse
import shlex
import sys
from typing import List, Optional, TextIO

from .device import build_graph, resolve_device
from .flatgfa import GraphArrays, parse_gfa, parse_gfa_file
from .ops import depth as depth_op


def _read_lines(filename: str) -> List[str]:
    with open(filename, "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def _load(args: argparse.Namespace) -> GraphArrays:
    if args.input:
        from .fileformat import load_flatgfa

        return load_flatgfa(args.input)
    if args.input_gfa:
        return parse_gfa_file(args.input_gfa)
    return parse_gfa(sys.stdin.buffer.read())


def _needs_masked_index(args) -> bool:
    """Only masked/batched subset-depth queries read the crossing
    matrix / tiered-ELL indexes; every other one-shot command skips
    building them. The serve loop always builds the full set. As in the
    reference, ``-S`` under ``-b`` still counts (the bed route never
    reads the indexes; the answer is the same either way)."""
    if args.command != "depth":
        return False
    return bool(
        getattr(args, "subset_batch", None)
        or (
            getattr(args, "seg_depth", False)
            and getattr(args, "subset_paths", None)
            and not getattr(args, "bed_input", None)
        )
    )


def _reference_grammar() -> argparse.ArgumentParser:
    """The reference CLI's grammar, flag for flag."""
    parser = argparse.ArgumentParser(prog="fgfa-torch")
    parser.add_argument("-i", "--input", help="read a binary FlatGFA file")
    parser.add_argument("-I", "--input-gfa", help="read a GFA text file")
    parser.add_argument("-o", "--output", help="write a binary FlatGFA file")
    parser.add_argument("-O", "--output-gfa", help="write a GFA text file")
    parser.add_argument(
        "-p",
        "--prealloc-factor",
        type=float,
        default=0.0,
        help="spare-capacity fraction for binary output",
    )
    parser.add_argument(
        "-m",
        "--mutate",
        action="store_true",
        help="write a transform's result back into the -i binary in place",
    )
    parser.add_argument(
        "--ell-objective",
        choices=["single", "batch"],
        default=None,
        help="plan the resident depth index for single-query latency "
        "(default) or batched-serving throughput (also: "
        "POLLEN_ELL_OBJECTIVE)",
    )
    sub = parser.add_subparsers(dest="command", metavar="COMMAND")

    sub.add_parser("paths", help="list the paths")
    sub.add_parser(
        "serve",
        help="answer streamed query lines over the resident graph "
        "(one CLI-grammar command per stdin line; responses framed "
        "with ##end)",
    )
    sub.add_parser("norm", help="emit the graph in normalized order")
    sub.add_parser("toc", help="print the pool table of contents").add_argument(
        "-b", "--bytes", action="store_true", help="sizes in bytes"
    )

    cmd = sub.add_parser("stats", help="graph statistics")
    cmd.add_argument("-S", "--summarize", action="store_true")
    cmd.add_argument("-L", "--self-loops", action="store_true")

    cmd = sub.add_parser("depth", help="segment or path depth")
    cmd.add_argument(
        "-d", "--graph-depth-table", action="store_true", dest="seg_depth"
    )
    cmd.add_argument(
        "-s", "--subset-paths", help="file listing paths to count"
    )
    cmd.add_argument(
        "-S",
        "--subset-batch",
        help="file with one comma-separated path subset per line; all "
        "subsets are answered in one batched device pass",
    )
    cmd.add_argument(
        "-r", "--path", action="append", default=[], help="path-depth rows"
    )
    cmd.add_argument(
        "-b", "--bed-input", help="depth for intervals from a BED file"
    )

    sub.add_parser("degree", help="per-segment degree table")

    cmd = sub.add_parser(
        "matrix", help="pangenotype matrix from GAF files"
    )
    cmd.add_argument("gaf_files", nargs="+")

    sub.add_parser("matrix-adj", help="sparse adjacency-matrix rendering")
    sub.add_parser("flatten", help="FASTA + BED rendering")

    cmd = sub.add_parser("bench", help="micro-benchmarks")
    cmd.add_argument("--wcl", help="count lines in a text file")
    cmd.add_argument("-p", "--parallel", action="store_true")
    sub.add_parser("validate", help="check links support paths")

    cmd = sub.add_parser("position", help="locate a bp offset on a path")
    cmd.add_argument(
        "-p",
        "--path-pos",
        required=True,
        help="path_name,offset,orientation",
    )

    cmd = sub.add_parser("overlap", help="paths sharing steps with queries")
    cmd.add_argument("--paths", required=True, help="file listing paths")

    cmd = sub.add_parser("chop", help="split segments to a max length")
    cmd.add_argument("-c", "--count", type=int, required=True)
    cmd.add_argument("-l", "--links", action="store_true")

    sub.add_parser("crush", help="squash runs of N")
    sub.add_parser("flip", help="orient paths forward")

    cmd = sub.add_parser("gaf", help="look up read positions from a GAF")
    cmd.add_argument("gaf_file")
    cmd.add_argument("-s", "--seqs", action="store_true")
    cmd.add_argument("-b", "--bench", action="store_true")
    cmd.add_argument(
        "-p",
        "--parallel",
        action="store_true",
        help="accepted for fgfa compatibility; the chunker is always "
        "batched-parallel here",
    )

    cmd = sub.add_parser("bed", help="intersect two BED files")
    cmd.add_argument("-a", dest="bed_a", required=True)
    cmd.add_argument("-b", dest="bed_b", required=True)

    cmd = sub.add_parser(
        "pangenotype", help="sample x segment matrix from GAF files"
    )
    cmd.add_argument("gaf_files", nargs="+")

    cmd = sub.add_parser(
        "window-depth", help="depth of equal windows along a path"
    )
    cmd.add_argument("path")
    cmd.add_argument("window", type=int)

    cmd = sub.add_parser(
        "bed-depth", help="depth of BED intervals along a path"
    )
    cmd.add_argument("-b", "--bed-input", required=True)

    cmd = sub.add_parser("extract", help="neighborhood subgraph")
    cmd.add_argument("-n", "--seg-name", type=int, required=True)
    cmd.add_argument("-c", "--link-distance", type=int, required=True)
    cmd.add_argument(
        "-d", "--max-distance-subpaths", type=int, default=300_000
    )
    cmd.add_argument("-e", "--max-merging-iterations", type=int, default=6)

    cmd = sub.add_parser("inject", help="add BED regions as new paths")
    cmd.add_argument("--bed", required=True)

    cmd = sub.add_parser(
        "seq-export", help="pack an ASCII nucleotide file"
    )
    cmd.add_argument("input")
    cmd.add_argument("output")

    cmd = sub.add_parser("seq-import", help="print a packed-seq file")
    cmd.add_argument("filename")

    return parser


def build_parser() -> argparse.ArgumentParser:
    parser = _reference_grammar()
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where the index lives and queries run (default: cuda; "
        "without a CUDA device this is an error)",
    )
    return parser


def _not_ported(what: str) -> ValueError:
    return ValueError(f"{what} is not ported yet (see ROADMAP.md)")


def _refuse_output(args) -> None:
    """``-o``/``-O`` name files the reference writes after the command
    (its ``_store``); the port has no writer yet, so it refuses them
    before it reads or answers anything."""
    if args.output or args.output_gfa:
        raise _not_ported("-o/-O output")


def _run_depth(args, g, dg, out: TextIO) -> None:
    # The reference's order: -b, then -S (with or without -d), then -d.
    if args.bed_input:
        raise _not_ported("depth -b")
    if args.subset_batch:
        subsets = [
            [p for p in line.replace(",", " ").split() if p]
            for line in _read_lines(args.subset_batch)
        ]
        out.write(depth_op.run_seg_depth_batch(g, dg, subsets))
    elif args.seg_depth:
        subset = _read_lines(args.subset_paths) if args.subset_paths else None
        out.write(depth_op.run_seg_depth(g, dg, subset))
    else:
        out.write(depth_op.run_path_depth(g, dg, args.path or None))


def main(
    argv: Optional[List[str]] = None,
    stdin: Optional[TextIO] = None,
    stdout: Optional[TextIO] = None,
) -> None:
    try:
        _main(argv, stdin or sys.stdin, stdout or sys.stdout)
    except BrokenPipeError:
        raise SystemExit(0)
    except (OSError, ValueError, KeyError, RuntimeError) as exc:
        print(f"fgfa-torch: error: {exc}", file=sys.stderr)
        raise SystemExit(1)


def _main(argv, stdin: TextIO, out: TextIO) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    _refuse_output(args)
    if args.command not in ("depth", "serve"):
        raise _not_ported(f"command {args.command or '(convert)'!r}")
    device = resolve_device(args.device)
    g = _load(args)
    if args.command == "serve":
        _serve(parser, args, g, device, stdin, out)
        return
    dg = build_graph(
        g,
        device,
        ell_objective=args.ell_objective,
        cross_matrix="auto" if _needs_masked_index(args) else "never",
    )
    _run_depth(args, g, dg, out)


def _serve(parser, args, g, device, stdin: TextIO, out: TextIO) -> None:
    """Answer one CLI-grammar depth request per input line over the
    resident graph; the index is built at the first request."""
    dg_cache: list = []

    def make_dg():
        if not dg_cache:
            dg_cache.append(
                build_graph(g, device, ell_objective=args.ell_objective)
            )
        return dg_cache[0]

    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            qargs = parser.parse_args(shlex.split(line))
            if qargs.command != "depth":
                raise _not_ported(f"serving {qargs.command!r}")
            if qargs.input or qargs.input_gfa:
                raise ValueError("serve requests cannot re-load graphs")
            _refuse_output(qargs)
            _run_depth(qargs, g, make_dg(), out)
            out.write("##end\tok\n")
        except BrokenPipeError:
            raise
        except SystemExit:
            out.write("##end\terror\tbad request\n")
        except Exception as exc:  # keep serving after a bad query
            msg = str(exc).replace("\n", " ")[:500]
            out.write(f"##end\terror\t{msg}\n")
        out.flush()


if __name__ == "__main__":
    main()
