"""``fgfa-torch``: the command-line tool of the PyTorch / CUDA port.

Requests parse with the reference CLI's own parser
(``pollen_tpu.cli.build_parser``), so every command line means what it
means to ``fgfa-tpu``. Served so far: ``depth`` (path depth, ``-r``),
``depth -d``, ``depth -d -s FILE``, ``depth -S FILE`` (one subset per
line, all answered in one batched device pass) and ``serve``, which
answers depth requests over one resident graph with the reference's
framing (``##end\\tok`` or ``##end\\terror\\t<message>`` after each
response). Every other command exits with "not ported yet".

``--device cuda|cpu`` (default ``cuda``) picks where the index lives and
the queries run. A ``cuda`` run without a card is an error.
"""

from __future__ import annotations

import argparse
import shlex
import sys
from typing import List, Optional, TextIO

from pollen_tpu.cli import _load, _needs_masked_index, _read_lines
from pollen_tpu.cli import build_parser as _reference_parser

from .device import build_graph, resolve_device
from .ops import depth as depth_op


def build_parser() -> argparse.ArgumentParser:
    parser = _reference_parser()
    parser.prog = "fgfa-torch"
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
