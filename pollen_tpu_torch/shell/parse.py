"""Shell front end: POSIX-ish command lines -> dataflow IR.

Reference semantics: flatgfa-sh/src/parse.rs. Quoting/escaping is
handled by a quote-aware lexer that keeps quoted operator characters
literal (``grep "|" f`` greps for a pipe character); pipelines wire
fresh pipe resources between stages; ``<``/``>`` redirections rebind a
stage's endpoints. Recognized
commands (``odgi depth``, ``bedtools makewindows``, ``gunzip``) lower to
in-process ops; anything else becomes an ``exec`` passthrough.

Accepted grammar note: the reference lexes with a full shell parser
(brush-parser) but its translator REJECTS everything beyond simple
commands, pipelines, ``;`` sequencing, and file redirections —
``&&``/``||`` and ``&`` hit explicit unimplemented!() arms
(parse.rs:195-209), and words expand no variables (parse.rs:238-251).
This front end accepts exactly that same language and raises the same
rejections, just as parse errors instead of panics.

The port's copy of the JAX package's pollen_tpu/shell/parse.py, unchanged,
including its lexer's drop of a lone trailing backslash
(``_read_word``: ``i += 2`` past the end), kept for parity.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from . import ir
from .ir import Program, Resource


class ShellParseError(ValueError):
    pass


class _Tok(str):
    """A lexed word. ``op`` is True only for UNQUOTED control tokens
    (``| ; < > & && || >> <<``): a quoted ``"|"`` must stay a literal
    argument word, exactly as the reference's shell parser keeps it
    (flatgfa-sh/src/parse.rs:238-251 turns quoted words into plain
    strings before the translator ever sees operators)."""

    op: bool = False

    def __new__(cls, s: str, op: bool = False) -> "_Tok":
        t = str.__new__(cls, s)
        t.op = op
        return t


def _is_op(tok: str, *vals: str) -> bool:
    return getattr(tok, "op", False) and str(tok) in vals


# Longest-match-first so "&&" never lexes as two "&".
_OPERATORS = ("&&", "||", ">>", "<<", "|", ";", "<", ">", "&")
_OP_CHARS = "|;<>&"


def _read_word(line: str, i: int) -> Tuple[str, int]:
    """Read one (possibly quoted) word starting at ``i``; returns the
    unquoted text and the index past it. Quote handling follows POSIX
    shell: single quotes are fully literal, double quotes allow
    backslash-escapes of ``\\ " $ ```, bare backslash escapes the
    next character."""
    out: List[str] = []
    n = len(line)
    while i < n and line[i] not in " \t" and line[i] not in _OP_CHARS:
        c = line[i]
        if c == "'":
            j = line.find("'", i + 1)
            if j < 0:
                raise ShellParseError("no closing quotation")
            out.append(line[i + 1 : j])
            i = j + 1
        elif c == '"':
            i += 1
            while i < n and line[i] != '"':
                if line[i] == "\\" and i + 1 < n and line[i + 1] in '\\"$`':
                    out.append(line[i + 1])
                    i += 2
                else:
                    out.append(line[i])
                    i += 1
            if i >= n:
                raise ShellParseError("no closing quotation")
            i += 1
        elif c == "\\":
            if i + 1 < n:
                out.append(line[i + 1])
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out), i


def _lex_line(line: str) -> List[_Tok]:
    toks: List[_Tok] = []
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c in " \t":
            i += 1
            continue
        if c == "#":
            break  # comment to end of line
        if c in _OP_CHARS:
            for op in _OPERATORS:
                if line.startswith(op, i):
                    toks.append(_Tok(op, op=True))
                    i += len(op)
                    break
            continue
        word, i = _read_word(line, i)
        toks.append(_Tok(word))
    return toks


def _split_statements(tokens: List[str]) -> List[List[str]]:
    out: List[List[str]] = [[]]
    for tok in tokens:
        if _is_op(tok, "&&", "||"):
            # Match the reference's explicit rejection
            # (parse.rs:205 "&& and || not supported").
            raise ShellParseError(f"{tok} is not supported")
        if _is_op(tok, "&"):
            raise ShellParseError("async commands are not supported")
        if _is_op(tok, ";"):
            if out[-1]:
                out.append([])
        else:
            out[-1].append(tok)
    return [s for s in out if s]


def _split_pipeline(tokens: List[str]) -> List[List[str]]:
    stages: List[List[str]] = [[]]
    for tok in tokens:
        if _is_op(tok, "|"):
            stages.append([])
        else:
            stages[-1].append(tok)
    if any(not s for s in stages):
        raise ShellParseError("empty pipeline stage")
    return stages


def _pop_redirects(
    prog: Program, tokens: List[str], src: Resource, dst: Resource
) -> Tuple[List[str], Resource, Resource]:
    args: List[str] = []
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if _is_op(tok, "<", ">"):
            # The lexer splits an attached `>file` into the operator
            # and its word, so the two-token form is the only one.
            if i + 1 >= len(tokens) or getattr(tokens[i + 1], "op", False):
                raise ShellParseError(f"missing target for {str(tok)!r}")
            target = prog.file(tokens[i + 1])
            if tok == "<":
                src = target
            else:
                dst = target
            i += 2
        elif _is_op(tok, ">>", "<<"):
            raise ShellParseError(
                f"{str(tok)!r} redirection is not supported"
            )
        else:
            args.append(tok)
            i += 1
    return args, src, dst


def _flag_value(args: List[str], *names: str) -> Optional[str]:
    for name in names:
        if name in args:
            i = args.index(name)
            if i + 1 >= len(args):
                raise ShellParseError(f"missing value for {name}")
            args.pop(i)
            return args.pop(i)
    return None


def _translate_odgi(
    prog: Program, args: List[str], src: Resource, dst: Resource
) -> None:
    args = list(args)
    in_file = _flag_value(args, "-i", "--input")
    if in_file is not None:
        src = prog.file(in_file)
    gfa = prog.load_gfa(src)

    if not args:
        raise ShellParseError("odgi: missing subcommand")
    sub = args.pop(0)
    if sub == "paths":
        if "-L" in args:
            args.remove("-L")
        prog.instr([gfa], dst, ir.PATHS)
        return
    if sub != "depth":
        raise ShellParseError(f"unsupported odgi subcommand {sub!r}")

    if "-d" in args:
        args.remove("-d")
        prog.instr([gfa], dst, ir.NODE_DEPTH)
        return
    bed_file = _flag_value(args, "-b")
    if bed_file is not None:
        bed = prog.load_bed(prog.file(bed_file))
        prog.instr([gfa, bed], dst, ir.INTERVAL_DEPTH)
        return
    prog.instr([gfa], dst, ir.PATH_DEPTH, path=_flag_value(args, "-r"))


def _translate_bedtools(
    prog: Program, args: List[str], src: Resource, dst: Resource
) -> None:
    args = list(args)
    if not args or args.pop(0) != "makewindows":
        raise ShellParseError("unsupported bedtools subcommand")
    bed_file = _flag_value(args, "-b")
    if bed_file is None:
        raise ShellParseError("bedtools makewindows needs -b")
    size = _flag_value(args, "-w")
    if size is None:
        raise ShellParseError("bedtools makewindows needs -w")
    bed_src = src if bed_file == "/dev/stdin" else prog.file(bed_file)
    bed = prog.load_bed(bed_src)
    prog.instr([bed], dst, ir.MAKE_WINDOWS, size=int(size))


def _translate_command(
    prog: Program, tokens: List[str], src: Resource, dst: Resource
) -> None:
    args, src, dst = _pop_redirects(prog, tokens[1:], src, dst)
    name = tokens[0]
    if name == "odgi":
        _translate_odgi(prog, args, src, dst)
    elif name == "bedtools":
        _translate_bedtools(prog, args, src, dst)
    elif name == "gunzip":
        if args:
            raise ShellParseError("no gunzip arguments are supported")
        prog.instr([src], dst, ir.GZIP_DECOMPRESS)
    else:
        prog.instr([src], dst, ir.EXEC, command=name, args=tuple(args))


def shell_to_ir(text: str) -> Program:
    """Parse shell text into an IR program."""
    # Lex line by line; an operator ";" after each line keeps the
    # statement boundaries.
    tokens: List[_Tok] = []
    for line in text.splitlines():
        tokens.extend(_lex_line(line))
        tokens.append(_Tok(";", op=True))
    prog = Program()
    for statement in _split_statements(tokens):
        stages = _split_pipeline(statement)
        src = ir.STDIN_R
        for i, stage in enumerate(stages):
            dst = (
                ir.STDOUT_R
                if i == len(stages) - 1
                else prog.fresh(ir.PIPE)
            )
            _translate_command(prog, stage, src, dst)
            src = dst
    return prog
