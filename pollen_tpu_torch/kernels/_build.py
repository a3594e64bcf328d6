"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded
with ``ctypes``. Nothing is compiled at import time: the CPU tests
import every module of the package on machines with no ``nvcc``.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one library. Its file name
carries a hash of the sources, headers and flags, so an edited kernel
never loads a stale build; a build writes to a temporary name and
renames it into place, so two processes building at once cannot load a
half-written file.

The library goes into ``pollen_tpu_torch/_build/`` beside the sources
when that directory can be written (a checkout), else into a per-user
cache directory, ``$XDG_CACHE_HOME`` or ``~/.cache``, then
``pollen_tpu_torch/<hash of the package's path>`` (an installed
package in a read-only site-packages).

Every C entry point returns ``cudaGetLastError()`` right after its
launch; :func:`check` turns a nonzero code into an exception (a refused
launch never runs, and a later synchronise would not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
LOCAL_BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the csrc/*.cu entry points (pointers and the stream
# as c_void_p: a bare Python int would be passed as a 32-bit int).
_MASK = (_P, _I, _I, _P, _I)  # mask, elem_bytes, n_paths, words, n_words
_RAW = (_P, _I, _I)  # a raw mask (no bit words): mask, elem_bytes, n_paths
SIGNATURES = {
    # slots, k, g, sub, pack16, raw mask, depth, uniq, stream
    "pollen_ell_tier": (_P, _I, _I, _I, _I, *_RAW, _P, _P, _P),
    # matrix, rows, n_pad, nibble, raw mask, depth, uniq, stream
    "pollen_cross_depth": (_P, _I, _L, _I, *_RAW, _P, _P, _P),
    "pollen_ell_flat": (
        _I,  # number of tiers
        _P, _I, _L, _P, _P,  # tier 0: slots, k, n_pad, depth, uniq
        _P, _I, _L, _P, _P,  # tier 1
        _P, _I, _L, _P, _P,  # tier 2
        *_RAW,
        _P,  # stream
    ),
    # probes.cu: mode, matrix, rows, n_pad, raw mask, flags, depth, uniq,
    # stream
    "pollen_cross_probe": (_I, _P, _I, _L, *_RAW, _P, _P, _P, _P),
    "pollen_ell_splitn": (
        _I,  # number of tiers
        _P, _I, _I, _P, _P,  # tier 0: slots, k, g, depth, uniq
        _P, _I, _I, _P, _P,  # tier 1
        _P, _I, _I, _P, _P,  # tier 2
        _P, _I, _I, _P, _P,  # heavy: bytes, rows, nh_pad, depth, uniq
        _I, _I,  # sub, pack16
        *_RAW,
        _P,  # stream
    ),
    # depth_batch.cu: masks are (q, n_paths), words q*n_words
    "pollen_cross_depth_batch": (
        _P, _I, _I, _I,  # matrix, rows, n_pad, nibble
        _P, _I, _I, _I, _P, _I,  # masks, elem_bytes, n_paths, q, words, n_words
        _P, _P, _P,  # depth, uniq, stream
    ),
    "pollen_ell_splitn_batch": (
        _I,  # number of tiers
        _P, _I, _I, _P, _P,  # tier 0: slots, k, g, depth, uniq
        _P, _I, _I, _P, _P,  # tier 1
        _P, _I, _I, _P, _P,  # tier 2
        _P, _I, _I, _P, _P,  # heavy: bytes, rows, nh_pad, depth, uniq
        _I, _I,  # sub, pack16
        _P, _I, _I, _I,  # raw masks, elem_bytes, n_paths, q
        _P, _L,  # scratch, its int32 words (ellscan.batch_scratch_words)
        _P,  # stream
    ),
    # scan.cu
    "pollen_scan_scratch_bytes": (_L,),  # n
    "pollen_seg_scan": (
        _P, _P, _L, _I, _P,  # path, run_start, n, head_carry, its device copy
        *_MASK,
        _P, _P, _P, _P,  # scratch, csum_w, csum_first, stream
    ),
    "pollen_run_scan": (
        _P, _P, _L,  # run_path, run_count, n
        *_MASK,
        _P, _P, _P, _P,  # scratch, csum_wc, csum_w, stream
    ),
    "pollen_boundary_diff": (
        _P, _P, _L, _P, _I, _P, _P, _P,  # c0, c1, len, bounds, n, o0, o1, stream
    ),
}
# Return types other than the launch's error code.
RESTYPES = {"pollen_scan_scratch_bytes": _L}

_lib = None
build_log = ""


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def _writable(path: pathlib.Path) -> bool:
    """Whether ``path`` can be written, or created in its parent."""
    if path.exists():
        return os.access(path, os.W_OK | os.X_OK)
    return os.access(path.parent, os.W_OK | os.X_OK)


def build_dir() -> pathlib.Path:
    """Where the library is built: ``LOCAL_BUILD_DIR`` if writable, else
    the per-user cache directory for this package's path."""
    if _writable(LOCAL_BUILD_DIR):
        return LOCAL_BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    key = hashlib.sha256(str(PKG).encode()).hexdigest()[:16]
    return pathlib.Path(cache) / "pollen_tpu_torch" / key


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libpollen_depth-{h.hexdigest()[:16]}.so"


def _compile(out: pathlib.Path) -> str:
    """One nvcc per source, all at once, then one link into ``out``.
    Returns the compilers' output; raises if a step fails."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = pathlib.Path(tmp) / f"{src.stem}.o"
            objs.append(obj)
            procs.append(
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                )
            )
        logs, failed = [], []
        for src, proc in zip(_sources(), procs):
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode})")
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(out), *map(str, objs)],
            capture_output=True,
            text=True,
        )
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{log}")
    return log


def load() -> ctypes.CDLL:
    """The kernel library, built on first call in this checkout."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            build_log = _compile(pathlib.Path(tmp))
        except BaseException:
            os.unlink(tmp)
            raise
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    _lib = lib
    return lib


def check(name: str, err: int) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
