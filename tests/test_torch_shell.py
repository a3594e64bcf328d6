"""``flash-torch`` against ``flash-tpu``: every case of
``tests/test_shell.py`` through both packages' ``run_program`` (the
port's on ``device="cpu"``), with the same expected bytes, the
``.flatgfa`` files written by each package's own ``save_flatgfa``; the
IR text of both front ends and optimizers on every command of those
cases; the lexer's trailing backslash; every console block of the
reference's shell README under ``flash-torch --device cpu``; and
``flash-torch`` without ``--device`` on a machine with no card.
"""

import gzip
import re
import shutil
import subprocess
import types

import pytest
import torch

import pollen_tpu.shell as ref_shell
import pollen_tpu_torch.shell as port_shell
from conftest import GOLDEN_DIR, GRAPH_DIR, REPO
from pollen_tpu.fileformat import save_flatgfa as ref_save_flatgfa
from pollen_tpu.flatgfa import parse_gfa_file as ref_parse_gfa_file
from pollen_tpu.shell.parse import ShellParseError as RefShellParseError
from pollen_tpu_torch.fileformat import save_flatgfa as port_save_flatgfa
from pollen_tpu_torch.flatgfa import parse_gfa_file as port_parse_gfa_file
from pollen_tpu_torch.scripts import script_env
from pollen_tpu_torch.shell.parse import ShellParseError

torch.set_num_threads(1)

TINY = str(GRAPH_DIR / "tiny.gfa")
GOLDEN_DEPTH = (GOLDEN_DIR / "tiny.depth").read_text()

SHELLS = {
    "ref": types.SimpleNamespace(
        shell_to_ir=ref_shell.shell_to_ir, optimize=ref_shell.optimize,
        run_program=ref_shell.run_program, error=RefShellParseError,
        save_flatgfa=ref_save_flatgfa, parse_gfa_file=ref_parse_gfa_file,
    ),
    "port": types.SimpleNamespace(
        shell_to_ir=port_shell.shell_to_ir, optimize=port_shell.optimize,
        run_program=lambda prog, stdin=b"": port_shell.run_program(
            prog, stdin, device="cpu"),
        error=ShellParseError,
        save_flatgfa=port_save_flatgfa, parse_gfa_file=port_parse_gfa_file,
    ),
}


@pytest.fixture(params=list(SHELLS))
def sh(request):
    return SHELLS[request.param]


def render(sh, text, opt=False):
    prog = sh.shell_to_ir(text)
    if opt:
        prog = sh.optimize(prog)
    return prog.render()


def run(sh, text, opt=False, stdin=b""):
    prog = sh.shell_to_ir(text)
    if opt:
        prog = sh.optimize(prog)
    return sh.run_program(prog, stdin).decode()


def test_ir_basic(sh):
    out = render(sh, f"odgi depth -i {TINY} -d")
    assert out == (
        f'parse-gfa("{TINY}") -> gfa-0\n' "node-depth(gfa-0) -> stdout\n"
    )


def test_unsupported_operators_rejected(sh):
    for text in (
        "odgi depth -d && echo done",
        "true || false",
        "sleep 1 &",
    ):
        with pytest.raises(sh.error):
            sh.shell_to_ir(text)


def test_quoted_operators_stay_literal(sh):
    prog = sh.shell_to_ir('grep "|" f')
    out = prog.render()
    assert "pipe" not in out
    (instr,) = prog.instrs
    assert instr.args["command"] == "grep"
    assert instr.args["args"] == ("|", "f")

    prog = sh.shell_to_ir('echo ">x" \'&&\' "a b"')
    (instr,) = prog.instrs
    assert instr.args["args"] == (">x", "&&", "a b")


def test_real_redirect_still_splits(sh, tmp_path):
    out = tmp_path / "o.txt"
    prog = sh.shell_to_ir(f"echo hi >{out}")
    (instr,) = prog.instrs
    assert instr.args["args"] == ("hi",)

    with pytest.raises(sh.error):
        sh.shell_to_ir('echo "unterminated')
    with pytest.raises(sh.error):
        sh.shell_to_ir("cat <<EOF")
    (instr,) = sh.shell_to_ir("echo \\|").instrs
    assert instr.args["args"] == ("|",)


def test_ir_pipeline_and_exec(sh):
    out = render(sh, f"odgi depth -i {TINY} -d | tail -n 2")
    assert "node-depth(gfa-0) -> pipe-0" in out
    assert "exec(pipe-0" in out and "command=tail" in out


def test_node_depth_matches_cli(sh):
    assert run(sh, f"odgi depth -i {TINY} -d") == GOLDEN_DEPTH


def test_exec_passthrough(sh):
    out = run(sh, f"odgi depth -i {TINY} -d | tail -n 1")
    assert out == "4\t1\t1\n"


def test_path_depth(sh):
    out = run(sh, f"odgi depth -i {TINY} -r alpha")
    assert out == "#path\tstart\tend\tmean.depth\nalpha\t0\t13\t1.46\n"


def test_makewindows_pipeline(sh):
    out = run(
        sh,
        f"odgi depth -i {TINY} -r alpha"
        " | bedtools makewindows -b /dev/stdin -w 5",
        opt=True,
    )
    assert out == "alpha\t0\t5\nalpha\t5\t10\nalpha\t10\t13\n"


def test_opt_depth_to_length(sh):
    text = (
        f"odgi depth -i {TINY} -r alpha"
        " | bedtools makewindows -b /dev/stdin -w 5"
    )
    assert "path-depth" in render(sh, text)
    optimized = render(sh, text, opt=True)
    assert "path-length" in optimized
    assert "parse-bed" not in optimized


def test_opt_flatgfa_substitution(sh, tmp_path):
    gfa = tmp_path / "g.gfa"
    shutil.copy(TINY, gfa)
    sh.save_flatgfa(str(tmp_path / "g.flatgfa"), sh.parse_gfa_file(TINY))
    text = f"odgi depth -i {gfa} -d"
    plain = render(sh, text)
    assert "parse-gfa" in plain
    optimized = render(sh, text, opt=True)
    assert "map-file" in optimized and "g.flatgfa" in optimized
    assert run(sh, text, opt=True) == GOLDEN_DEPTH


def test_opt_og_view_elimination(sh, tmp_path):
    og = tmp_path / "g.og"
    og.write_bytes(b"fake odgi file")
    shutil.copy(TINY, tmp_path / "g.gfa")
    text = f"odgi depth -i {og} -d"
    plain = render(sh, text)
    assert "odgi-view" in plain
    optimized = render(sh, text, opt=True)
    assert "odgi-view" not in optimized
    assert "g.gfa" in optimized


def test_opt_dedup_map_file(sh, tmp_path):
    sh.save_flatgfa(str(tmp_path / "g.flatgfa"), sh.parse_gfa_file(TINY))
    flat = tmp_path / "g.flatgfa"
    text = f"odgi depth -i {flat} -d ; odgi depth -i {flat} -r alpha"
    optimized = render(sh, text, opt=True)
    assert optimized.count("map-file") == 1
    assert run(sh, text, opt=True) == GOLDEN_DEPTH + (
        "#path\tstart\tend\tmean.depth\nalpha\t0\t13\t1.46\n")


def test_gzip_input(sh, tmp_path):
    gz = tmp_path / "g.gfa.gz"
    gz.write_bytes(gzip.compress(open(TINY, "rb").read()))
    plain = render(sh, f"odgi depth -i {gz} -d")
    assert "gzip-decompress" in plain
    optimized = render(sh, f"odgi depth -i {gz} -d", opt=True)
    assert "gzip-decompress" not in optimized
    assert "gz " in optimized
    assert run(sh, f"odgi depth -i {gz} -d") == GOLDEN_DEPTH
    assert run(sh, f"odgi depth -i {gz} -d", opt=True) == GOLDEN_DEPTH


def test_stdin_redirect_and_cat(sh):
    data = open(TINY, "rb").read()
    assert run(sh, "odgi depth -d", stdin=data) == GOLDEN_DEPTH


def test_file_output_redirect(sh, tmp_path):
    target = tmp_path / "out.txt"
    run(sh, f"odgi depth -i {TINY} -d > {target}")
    assert target.read_text() == GOLDEN_DEPTH


def test_interval_depth(sh, tmp_path):
    windows = tmp_path / "w.bed"
    run(
        sh,
        f"odgi depth -i {TINY} -r alpha"
        f" | bedtools makewindows -b /dev/stdin -w 5 > {windows}",
    )
    out = run(sh, f"odgi depth -i {TINY} -b {windows}")
    lines = out.strip().split("\n")
    assert lines[0] == "#path\tstart\tend\tmean.depth"
    assert len(lines) == 4
    assert lines[1].startswith("alpha\t0\t5\t")


def test_run_program_outputs_equal(tmp_path):
    """The cases' programs that print, run through both packages: the
    same stdout bytes (interval depth's means included)."""
    windows = tmp_path / "w.bed"
    SHELLS["ref"].run_program(SHELLS["ref"].shell_to_ir(
        f"odgi depth -i {TINY} -r alpha"
        f" | bedtools makewindows -b /dev/stdin -w 5 > {windows}"))
    texts = [
        f"odgi depth -i {TINY} -d",
        f"odgi depth -i {TINY}",
        f"odgi depth -i {TINY} -r beta | bedtools makewindows "
        "-b /dev/stdin -w 3",
        f"odgi depth -i {TINY} -b {windows}",
        f"odgi paths -i {TINY} -L",
    ]
    for text in texts:
        for opt in (False, True):
            outs = {name: run(sh, text, opt=opt) for name, sh in SHELLS.items()}
            assert outs["port"] == outs["ref"], (text, opt)
            assert outs["port"], text


# Every command of the cases above (the file names are fixed stand-ins:
# rendering needs no file).
IR_COMMANDS = [
    f"odgi depth -i {TINY} -d",
    f"odgi depth -i {TINY} -d | tail -n 2",
    f"odgi depth -i {TINY} -r alpha",
    f"odgi depth -i {TINY} -r alpha | bedtools makewindows -b /dev/stdin -w 5",
    f"odgi depth -i {TINY} -r alpha | bedtools makewindows -b /dev/stdin "
    "-w 5 > w.bed",
    f"odgi depth -i {TINY} -b w.bed",
    "odgi depth -i g.og -d",
    "odgi depth -i g.flatgfa -d ; odgi depth -i g.flatgfa -r alpha",
    "odgi depth -i g.gfa.gz -d",
    "odgi depth -d",
    f"odgi depth -i {TINY} -d > out.txt",
    f"odgi paths -i {TINY} -L",
    'grep "|" f',
    'echo ">x" \'&&\' "a b"',
    "echo hi >o.txt",
    "echo \\|",
    "gunzip < a.gz | odgi depth -d",
]


@pytest.mark.parametrize("text", IR_COMMANDS)
def test_ir_text_equal(text):
    for opt in (False, True):
        assert render(SHELLS["port"], text, opt) == render(
            SHELLS["ref"], text, opt), opt


def test_trailing_backslash_dropped_by_both_lexers():
    """A lone trailing backslash is dropped (the reference lexer's
    ``i += 2`` past the end), kept in the port for parity."""
    for text in ("echo a\\", "echo \\", "echo 'x' y\\"):
        got, want = (sh.shell_to_ir(text).instrs[0].args["args"]
                     for sh in (SHELLS["port"], SHELLS["ref"]))
        assert got == want, text
    (instr,) = SHELLS["port"].shell_to_ir("echo a\\").instrs
    assert instr.args["args"] == ("a",)


README = REPO / "pollen_tpu" / "shell" / "README.md"
_BLOCK = re.compile(r"```console\n\$ (.*?)\n(.*?)```", re.S)
BLOCKS = [(m.group(1), m.group(2)) for m in _BLOCK.finditer(README.read_text())]


@pytest.mark.parametrize(
    "command,expected", BLOCKS, ids=[c[:40] for c, _ in BLOCKS]
)
def test_reference_readme_block(command, expected):
    """The reference README's console blocks, ``flash-tpu`` replaced by
    ``flash-torch --device cpu``, through the port's console scripts."""
    assert command.startswith("flash-tpu ")
    command = "flash-torch --device cpu" + command[len("flash-tpu"):]
    result = subprocess.run(
        command,
        shell=True,
        cwd=REPO,
        stdin=subprocess.DEVNULL,
        capture_output=True,
        text=True,
        timeout=120,
        env=script_env(),
    )
    assert result.returncode == 0, result.stderr[-500:]
    assert result.stdout == expected


def test_readme_has_every_block():
    assert len(BLOCKS) >= 7


def test_flash_torch_without_device_needs_a_card():
    """The default device is cuda: with no card visible, flash-torch
    exits non-zero and prints nothing on stdout."""
    env = script_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    result = subprocess.run(
        ["flash-torch", "-c", f"odgi depth -i {TINY} -d"],
        cwd=REPO, stdin=subprocess.DEVNULL, capture_output=True, text=True,
        timeout=120, env=env,
    )
    assert result.returncode != 0
    assert result.stdout == ""
    assert "no CUDA device" in result.stderr


def test_run_program_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = port_shell.shell_to_ir(f"odgi depth -i {TINY} -d")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_shell.run_program(prog)


def test_scripts_resolve_the_port_clis():
    """script_env() puts fgfa-torch, flash-torch, exine-torch and
    pollen-spec-torch on PATH, each running its package's __main__."""
    from pollen_tpu_torch.scripts import SCRIPTS

    assert SCRIPTS == {
        "fgfa-torch": "pollen_tpu_torch",
        "flash-torch": "pollen_tpu_torch.shell",
        "exine-torch": "pollen_tpu_torch.accel",
        "pollen-spec-torch": "pollen_tpu_torch.spec",
    }
    env = script_env()
    for name in SCRIPTS:
        assert shutil.which(name, path=env["PATH"]), name
    result = subprocess.run(
        "fgfa-torch --device cpu -I tests/graphs/tiny.gfa depth -d",
        shell=True, cwd=REPO, stdin=subprocess.DEVNULL, capture_output=True,
        text=True, timeout=120, env=env,
    )
    assert result.returncode == 0, result.stderr[-500:]
    assert result.stdout == GOLDEN_DEPTH
