"""``flash-torch``: the shell-DSL command.

Usage (reference: flatgfa-sh/src/main.rs; the port's copy of the JAX
package's ``flash-tpu``, pollen_tpu/shell/__main__.py):

    flash-torch -c 'odgi depth -i graph.gfa -d | tail -n 2'
    flash-torch [-O] [-p] [--device cuda|cpu] script.sh
    flash-torch            # REPL

``-O`` enables the optimizer; ``-p`` pretend-prints the IR instead of
running it. ``--device`` is where graph indexes are built and queried
(default: cuda; without a CUDA device this is an error).
"""

from __future__ import annotations

import argparse
import sys

from ..device import resolve_device
from .evaluate import run_program
from .opt import optimize
from .parse import shell_to_ir


def run_shell(text: str, do_opt: bool, pretend: bool, device="cuda") -> None:
    prog = shell_to_ir(text)
    if do_opt:
        prog = optimize(prog)
    if pretend:
        sys.stdout.write(prog.render())
        return
    stdin = b"" if sys.stdin.isatty() else sys.stdin.buffer.read()
    sys.stdout.buffer.write(run_program(prog, stdin, device))
    sys.stdout.flush()


def main() -> None:
    parser = argparse.ArgumentParser(prog="flash-torch")
    parser.add_argument("-c", "--command", help="run one command string")
    parser.add_argument(
        "-O", "--optimize", action="store_true", help="optimize the IR"
    )
    parser.add_argument(
        "-p",
        "--pretend",
        action="store_true",
        help="print the IR instead of running",
    )
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where graph indexes are built and queried (default: cuda; "
        "without a CUDA device this is an error)",
    )
    parser.add_argument("script", nargs="?", help="script file to run")
    args = parser.parse_args()
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        parser.exit(1, f"flash-torch: error: {exc}\n")

    if args.command is not None:
        run_shell(args.command, args.optimize, args.pretend, device)
    elif args.script:
        with open(args.script, "r", encoding="utf-8") as f:
            run_shell(f.read(), args.optimize, args.pretend, device)
    else:
        # REPL.
        while True:
            try:
                line = input("flash> ")
            except EOFError:
                break
            if line.strip():
                try:
                    run_shell(line, args.optimize, args.pretend, device)
                except Exception as exc:  # keep the REPL alive
                    print(f"error: {exc}", file=sys.stderr)


if __name__ == "__main__":
    main()
