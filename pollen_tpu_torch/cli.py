"""``fgfa-torch``: the command-line tool of the PyTorch / CUDA port.

The grammar is the port's own copy of the reference CLI's
(``pollen_tpu/cli.py`` ``build_parser``, ``_load``, ``_store``,
``_emit_transform``, ``_toc_text``, ``_read_lines`` and the command
dispatch), every flag and default kept, so that every command line
means what it means to ``fgfa-tpu``; ``--device`` is added. Every
command of the reference is answered: the no-command conversion
(``-I x.gfa -o y.flatgfa``, or the preserved GFA on stdout), ``paths``,
``norm``, ``toc``, ``stats``, ``depth`` (all forms: ``-d``, ``-s``,
``-S``, ``-r``, ``-b``), ``degree``, ``matrix-adj``, ``flatten``,
``validate``, ``position``, ``overlap``, ``window-depth``,
``bed-depth``, ``bed``, ``crush``, ``flip``, ``chop``, ``gaf`` (``-s``,
``-b``; ``-p`` is accepted and ignored), ``matrix`` and ``pangenotype``
(one command), ``extract`` (``-o``/``-O`` write the subgraph),
``inject``, ``seq-export``, ``seq-import`` and ``bench --wcl`` (the
last three before any graph is loaded), and ``serve``, which answers
any of them but ``seq-*`` and ``bench`` over one resident graph with
the reference's framing (``##end\tok`` or ``##end\terror\t<message>``
after each response). ``-o``, ``-O`` and ``-m`` write what the
reference writes.

``--device cuda|cpu`` (default ``cuda``) picks where the index lives and
the queries run. A ``cuda`` run without a card is an error.
"""

from __future__ import annotations

import argparse
import shlex
import sys
from typing import List, Optional, TextIO

from .device import build_graph, resolve_device
from .emit import emit_gfa
from .flatgfa import GraphArrays, parse_gfa, parse_gfa_file


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


def _store(args: argparse.Namespace, g: GraphArrays) -> bool:
    """Write the graph per the output flags; True if something was written."""
    if args.output:
        from .fileformat import save_flatgfa

        save_flatgfa(args.output, g, spare=args.prealloc_factor)
        return True
    if args.output_gfa:
        from .emit import emit_gfa_to_file

        emit_gfa_to_file(g, args.output_gfa)
        return True
    return False


def _emit_transform(args, out, arena: GraphArrays, **emit_kw) -> None:
    """Write a transform result: in place into the -i binary under -m,
    otherwise as GFA text."""
    if args.mutate and args.input:
        from .fileformat import update_in_place

        update_in_place(args.input, arena)
    else:
        out.write(emit_gfa(arena, **emit_kw))


def _needs_masked_index(args) -> bool:
    """Only masked/batched subset-depth queries read the crossing
    matrix / tiered-ELL indexes; every other one-shot command skips
    building them. The serve loop always builds the full set. ``-b``
    answers before ``-S`` or ``-s`` is read and never reads the
    indexes, so ``depth -b`` builds none, whatever else is given (the
    reference still builds them for ``depth -b X -S Y``)."""
    if args.command != "depth" or getattr(args, "bed_input", None):
        return False
    return bool(
        getattr(args, "subset_batch", None)
        or (
            getattr(args, "seg_depth", False)
            and getattr(args, "subset_paths", None)
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


# The commands serve refuses (the reference's set).
NOT_SERVED = frozenset(("serve", "seq-export", "seq-import", "bench"))


def _toc_text(g: GraphArrays, in_bytes: bool) -> str:
    from .fileformat import _POOL_ELEM, _pools_of

    pools = _pools_of(g)
    lines = []
    for name, arr in pools.items():
        count = arr.shape[0]
        if in_bytes:
            count *= _POOL_ELEM[name].itemsize
        label = "optional_data" if name == "optional_data" else name
        lines.append(f"{label}: {count}")
    return "\n".join(lines) + "\n"


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
    device = resolve_device(args.device)

    # Sequence packing and the micro-benchmark need no graph at all.
    if args.command == "seq-export":
        from .packedseq import seq_export

        seq_export(args.input, args.output)
        return
    if args.command == "seq-import":
        from .packedseq import seq_import

        out.write(seq_import(args.filename).decode() + "\n")
        return
    if args.command == "bench":
        if args.wcl:
            from .ops.bench import line_count

            out.write(f"{line_count(args.wcl, args.parallel)}\n")
        return

    # Pure GFA -> binary conversion: one native pass straight from text
    # to the output file, never materializing Python-side pools (the
    # reference's prealloc_translate, cli/main.rs:216-248); parse and
    # write where the scanner is not built or rejects the text.
    if args.command is None and args.input_gfa and args.output:
        from .fileformat import save_flatgfa
        from .native import convert_gfa_native

        with open(args.input_gfa, "rb") as f:
            data = f.read()
        if convert_gfa_native(data, args.output, args.prealloc_factor):
            return
        save_flatgfa(args.output, parse_gfa(data), spare=args.prealloc_factor)
        return

    g = _load(args)
    if args.command == "serve":
        _serve(parser, args, g, device, stdin, out)
        return

    dg_cache: list = []

    def make_dg():
        if not dg_cache:
            dg_cache.append(
                build_graph(
                    g,
                    device,
                    ell_objective=args.ell_objective,
                    cross_matrix=(
                        "auto" if _needs_masked_index(args) else "never"
                    ),
                )
            )
        return dg_cache[0]

    _run_command(parser, args, g, device, out, make_dg)


def _serve(parser, args, g, device, stdin: TextIO, out: TextIO) -> None:
    """Query server: the graph (and its device index, built at the
    first request that needs it, in full) stays resident while
    CLI-grammar request lines stream on stdin; each response is the
    command's output and a frame line ``##end\tok`` or
    ``##end\terror\t<message>``."""
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
            if qargs.command in NOT_SERVED:
                raise ValueError(f"command {qargs.command!r} is not served")
            if qargs.input or qargs.input_gfa:
                raise ValueError("serve requests cannot re-load graphs")
            _run_command(parser, qargs, g, device, out, make_dg)
            out.write("##end\tok\n")
        except BrokenPipeError:
            raise
        except SystemExit:
            out.write("##end\terror\tbad request\n")
        except Exception as exc:  # keep serving after a bad query
            msg = str(exc).replace("\n", " ")[:500]
            out.write(f"##end\terror\t{msg}\n")
        out.flush()


def _run_command(parser, args, g: GraphArrays, device, out, make_dg) -> None:
    """One command over the loaded graph, as the reference dispatches it;
    then ``_store`` writes ``-o``/``-O``."""
    if args.command is None:
        if not _store(args, g):
            out.write(emit_gfa(g, order="preserved"))
        return

    if args.command == "paths":
        for name in g.path_names():
            out.write(name.decode() + "\n")
    elif args.command == "norm":
        out.write(emit_gfa(g, order="sorted"))
    elif args.command == "toc":
        out.write(_toc_text(g, args.bytes))
    elif args.command == "stats":
        from .ops.validate import run_stats

        out.write(run_stats(g, self_loops=args.self_loops))
    elif args.command == "matrix-adj":
        from .ops.matrix import run_matrix

        out.write(run_matrix(g))
    elif args.command == "validate":
        from .ops.validate import run_validate

        out.write(run_validate(g, device))
    elif args.command == "crush":
        from .ops.transform import crush

        _emit_transform(args, out, crush(g), order="sorted")
    elif args.command in ("pangenotype", "matrix"):
        from .ops.gaf import run_pangenotype

        out.write(run_pangenotype(g, args.gaf_files))
    elif args.command == "extract":
        from .ops.extract import extract

        sub_g = extract(
            g,
            args.seg_name,
            args.link_distance,
            args.max_distance_subpaths,
            args.max_merging_iterations,
        )
        # -o/-O write the subgraph, and the input is not stored after.
        if not _store(args, sub_g):
            out.write(emit_gfa(sub_g, order="normalized"))
        return
    elif args.command == "inject":
        from .bed import parse_bed_file
        from .ops.inject import inject

        new_g = inject(g, parse_bed_file(args.bed))
        _emit_transform(
            args, out, new_g, order="sorted", include_links=False
        )
    elif args.command == "bed":
        from .bed import parse_bed_file, run_bed_intersect

        out.write(
            run_bed_intersect(
                parse_bed_file(args.bed_a), parse_bed_file(args.bed_b)
            )
        )
    elif args.command == "chop":
        from .ops.transform import chop

        _emit_transform(
            args,
            out,
            chop(g, args.count, with_links=args.links),
            order="sorted",
            include_links=args.links,
        )
    elif args.command == "flip":
        from .ops.transform import flip

        flipped, sort_keys = flip(g, make_dg())
        _emit_transform(
            args, out, flipped, order="sorted", path_sort_keys=sort_keys
        )
    else:
        # Device-graph-backed queries (index built once, then cached).
        dg = make_dg()
        if args.command == "depth":
            _run_depth(args, g, dg, out)
        elif args.command == "degree":
            from .ops.degree import run_degree

            out.write(run_degree(g, dg))
        elif args.command == "flatten":
            from .ops.flatten import run_flatten

            name = args.input_gfa or args.input or "graph"
            base = name.rsplit(".", 1)[0]
            out.write(run_flatten(g, dg, f"{base}.og"))
        elif args.command == "position":
            from .ops.position import run_position

            parts = args.path_pos.split(",")
            if len(parts) != 3:
                parser.error("position must be path_name,offset,orientation")
            result = run_position(g, dg, parts[0], int(parts[1]))
            if result:
                out.write(result)
        elif args.command == "overlap":
            from .ops.overlap import run_overlap

            out.write(run_overlap(g, dg, _read_lines(args.paths)))
        elif args.command == "gaf":
            from .ops.gaf import run_gaf_lookup_stream

            for piece in run_gaf_lookup_stream(
                g, dg, args.gaf_file, seqs=args.seqs, bench=args.bench
            ):
                out.write(piece)
        elif args.command == "window-depth":
            from .ops.window_depth import run_window_depth

            out.write(run_window_depth(g, dg, args.path, args.window))
        elif args.command == "bed-depth":
            from .bed import parse_bed_file
            from .ops.window_depth import run_bed_depth

            out.write(run_bed_depth(g, dg, parse_bed_file(args.bed_input)))

    _store(args, g)


def _run_depth(args, g, dg, out: TextIO) -> None:
    # The reference's order: -b, then -S (with or without -d), then -d.
    from .ops import depth as depth_op

    if args.bed_input:
        from .bed import parse_bed_file
        from .ops.window_depth import run_bed_depth

        out.write(run_bed_depth(g, dg, parse_bed_file(args.bed_input)))
    elif args.subset_batch:
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


if __name__ == "__main__":
    main()
