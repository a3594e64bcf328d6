"""Native (C++) host components, bridged with ctypes.

The port's own copy of the JAX package's native layer
(pollen_tpu/native): the single-pass GFA scanner (``gfa_scan.cpp``,
split across ``POLLEN_SCAN_THREADS`` threads), its preserved-order
emitter, the direct GFA -> FlatGFA converter and the C API
(``capi.cpp``, ``pollen_capi.h``, ``example.c``). The C++ sources are
byte copies; only the build differs.

The scanner is compiled with the host ``g++`` at first use into
``pollen_tpu_torch/_build/`` (a checkout), or into the per-user cache
directory where the package is read-only (the same directory as the
CUDA kernels, :func:`pollen_tpu_torch.kernels._build.build_dir`). The
library's name, ``libpollen_scan_torch-<hash>.so``, carries a hash of
the source and the flags, so an edited scanner never loads a stale
build, and neither package ever loads the other's library. A build
writes to a temporary name and renames it into place, so two processes
building at once cannot load a half-written file.

When the toolchain or the build is unavailable, or the input uses a
corner of the grammar the scanner rejects, callers fall back to the
vectorized NumPy parser and emitter, which give identical arrays and
bytes. Set ``POLLEN_NATIVE=0`` to disable the native path; it is read
at every call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Optional

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "gfa_scan.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error = ""  # the compiler's message when the build failed


class _GfaOut(ctypes.Structure):
    _fields_ = [
        ("n_segs", ctypes.c_uint64),
        ("seg_name", ctypes.POINTER(ctypes.c_int64)),
        ("seg_seq", ctypes.POINTER(ctypes.c_uint32)),
        ("seg_opt", ctypes.POINTER(ctypes.c_uint32)),
        ("n_paths", ctypes.c_uint64),
        ("path_name", ctypes.POINTER(ctypes.c_uint32)),
        ("path_steps", ctypes.POINTER(ctypes.c_uint32)),
        ("path_olaps", ctypes.POINTER(ctypes.c_uint32)),
        ("n_links", ctypes.c_uint64),
        ("link_from", ctypes.POINTER(ctypes.c_uint32)),
        ("link_to", ctypes.POINTER(ctypes.c_uint32)),
        ("link_olap", ctypes.POINTER(ctypes.c_uint32)),
        ("n_steps", ctypes.c_uint64),
        ("steps", ctypes.POINTER(ctypes.c_uint32)),
        ("n_seq", ctypes.c_uint64),
        ("seq_data", ctypes.POINTER(ctypes.c_uint8)),
        ("n_overlaps", ctypes.c_uint64),
        ("overlaps", ctypes.POINTER(ctypes.c_uint32)),
        ("n_align", ctypes.c_uint64),
        ("alignment", ctypes.POINTER(ctypes.c_uint32)),
        ("n_name_data", ctypes.c_uint64),
        ("name_data", ctypes.POINTER(ctypes.c_uint8)),
        ("n_opt_data", ctypes.c_uint64),
        ("opt_data", ctypes.POINTER(ctypes.c_uint8)),
        ("n_lines", ctypes.c_uint64),
        ("line_order", ctypes.POINTER(ctypes.c_uint8)),
        ("n_header", ctypes.c_uint64),
        ("header", ctypes.POINTER(ctypes.c_uint8)),
    ]


def library_path() -> pathlib.Path:
    """Where the scanner library is (or will be) built."""
    from ..kernels._build import build_dir

    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return build_dir() / f"libpollen_scan_torch-{h.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> bool:
    """Compile the scanner into ``out`` (through a temporary file in its
    directory); False, with :data:`build_error` set, where it fails."""
    global build_error
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
    except OSError as exc:
        build_error = f"cannot write {out.parent}: {exc}"
        return False
    try:
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", tmp, str(_SRC)],
            capture_output=True,
            text=True,
        )
    except FileNotFoundError:
        os.unlink(tmp)
        build_error = "g++ not found"
        return False
    if proc.returncode != 0:
        os.unlink(tmp)
        build_error = f"g++ failed (exit {proc.returncode}):\n{proc.stderr}"
        return False
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if os.environ.get("POLLEN_NATIVE", "1") == "0":
        return None
    if _tried:
        return _lib
    _tried = True
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.gfa_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.POINTER(_GfaOut),
    ]
    lib.gfa_parse.restype = ctypes.c_int
    lib.gfa_free.argtypes = [ctypes.POINTER(_GfaOut)]
    lib.gfa_emit.argtypes = [
        ctypes.POINTER(_GfaOut),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.gfa_emit.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.gfa_text_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.gfa_convert.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_char_p,
        ctypes.c_double,
    ]
    lib.gfa_convert.restype = ctypes.c_int
    lib.gfa_emit_file.argtypes = [
        ctypes.POINTER(_GfaOut),
        ctypes.c_char_p,
    ]
    lib.gfa_emit_file.restype = ctypes.c_int
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _arr(ptr, count, dtype):
    if count == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)


def _fill_struct(out, g) -> list:
    """Populate a _GfaOut with pointers into (contiguous copies of) a
    GraphArrays' pools; returns the keep-alive list."""
    keep = []

    def ptr(arr, dtype, ctype):
        a = np.ascontiguousarray(arr, dtype=dtype).reshape(-1)
        keep.append(a)
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    out.n_segs = g.num_segments
    out.seg_name = ptr(g.seg_name, np.int64, ctypes.c_int64)
    out.seg_seq = ptr(g.seg_seq, np.uint32, ctypes.c_uint32)
    out.seg_opt = ptr(g.seg_optional, np.uint32, ctypes.c_uint32)
    out.n_paths = g.num_paths
    out.path_name = ptr(g.path_name, np.uint32, ctypes.c_uint32)
    out.path_steps = ptr(g.path_steps, np.uint32, ctypes.c_uint32)
    out.path_olaps = ptr(g.path_overlaps, np.uint32, ctypes.c_uint32)
    out.n_links = g.num_links
    out.link_from = ptr(g.link_from, np.uint32, ctypes.c_uint32)
    out.link_to = ptr(g.link_to, np.uint32, ctypes.c_uint32)
    out.link_olap = ptr(g.link_overlap, np.uint32, ctypes.c_uint32)
    out.n_steps = g.num_steps
    out.steps = ptr(g.steps, np.uint32, ctypes.c_uint32)
    out.n_seq = g.seq_data.shape[0]
    out.seq_data = ptr(g.seq_data, np.uint8, ctypes.c_uint8)
    out.n_overlaps = g.overlaps.shape[0]
    out.overlaps = ptr(g.overlaps, np.uint32, ctypes.c_uint32)
    out.n_align = g.alignment.shape[0]
    out.alignment = ptr(g.alignment, np.uint32, ctypes.c_uint32)
    out.n_name_data = g.name_data.shape[0]
    out.name_data = ptr(g.name_data, np.uint8, ctypes.c_uint8)
    out.n_opt_data = g.optional_data.shape[0]
    out.opt_data = ptr(g.optional_data, np.uint8, ctypes.c_uint8)
    out.n_lines = g.line_order.shape[0]
    out.line_order = ptr(g.line_order, np.uint8, ctypes.c_uint8)
    out.n_header = g.header.shape[0]
    out.header = ptr(g.header, np.uint8, ctypes.c_uint8)
    return keep


def emit_gfa_native(g) -> Optional[str]:
    """Render preserved-order GFA text with the C++ emitter; None means
    "fall back to the Python emitter"."""
    lib = _load()
    if lib is None:
        return None
    out = _GfaOut()
    keep = _fill_struct(out, g)
    size = ctypes.c_uint64()
    buf = lib.gfa_emit(ctypes.byref(out), ctypes.byref(size))
    del keep
    if not buf:
        return None
    try:
        return ctypes.string_at(buf, size.value).decode("ascii")
    finally:
        lib.gfa_text_free(buf)


def emit_gfa_file_native(g, out_path: str) -> bool:
    """Render preserved-order GFA text straight to ``out_path`` with the
    C++ emitter — no Python string materialization (the transform
    commands are emit-bound). False means "fall back"."""
    lib = _load()
    if lib is None:
        return False
    out = _GfaOut()
    keep = _fill_struct(out, g)
    code = lib.gfa_emit_file(ctypes.byref(out), os.fsencode(out_path))
    del keep
    if code >= 100:
        raise OSError(f"native GFA emit failed writing {out_path}")
    return code == 0


def convert_gfa_native(
    data: bytes, out_path: str, spare: float = 0.0
) -> bool:
    """Parse GFA text and write the binary FlatGFA file in one native
    pass (the reference's prealloc_translate, cli/main.rs:216-248) —
    no Python-side pool arrays. False means "fall back to parse + save".
    """
    lib = _load()
    if lib is None:
        return False
    code = lib.gfa_convert(
        data, len(data), os.fsencode(out_path), float(spare)
    )
    if code >= 100:
        raise OSError(f"native FlatGFA conversion failed writing {out_path}")
    return code == 0


def parse_gfa_native(data: bytes):
    """Parse GFA text with the C++ scanner; None means "fall back"."""
    lib = _load()
    if lib is None:
        return None
    out = _GfaOut()
    code = lib.gfa_parse(data, len(data), ctypes.byref(out))
    if code != 0:
        # The scanner only populates the struct on success; nothing to
        # free here.
        return None
    try:
        from ..flatgfa import GraphArrays

        n, p, l = int(out.n_segs), int(out.n_paths), int(out.n_links)
        return GraphArrays(
            header=_arr(out.header, int(out.n_header), np.uint8),
            seg_name=_arr(out.seg_name, n, np.int64),
            seg_seq=_arr(out.seg_seq, 2 * n, np.uint32).reshape(n, 2),
            seg_optional=_arr(out.seg_opt, 2 * n, np.uint32).reshape(n, 2),
            path_name=_arr(out.path_name, 2 * p, np.uint32).reshape(p, 2),
            path_steps=_arr(out.path_steps, 2 * p, np.uint32).reshape(p, 2),
            path_overlaps=_arr(out.path_olaps, 2 * p, np.uint32).reshape(
                p, 2
            ),
            link_from=_arr(out.link_from, l, np.uint32),
            link_to=_arr(out.link_to, l, np.uint32),
            link_overlap=_arr(out.link_olap, 2 * l, np.uint32).reshape(l, 2),
            steps=_arr(out.steps, int(out.n_steps), np.uint32),
            seq_data=_arr(out.seq_data, int(out.n_seq), np.uint8),
            overlaps=_arr(
                out.overlaps, 2 * int(out.n_overlaps), np.uint32
            ).reshape(int(out.n_overlaps), 2),
            alignment=_arr(out.alignment, int(out.n_align), np.uint32),
            name_data=_arr(out.name_data, int(out.n_name_data), np.uint8),
            optional_data=_arr(out.opt_data, int(out.n_opt_data), np.uint8),
            line_order=_arr(out.line_order, int(out.n_lines), np.uint8),
        )
    finally:
        lib.gfa_free(ctypes.byref(out))
