"""The FlatGFA binary file format, read side (``fgfa-torch -i FILE``).

The port's own copy of the loader of the JAX package's file format
(pollen_tpu/fileformat.py ``load_flatgfa``), byte-compatible with the
reference's on-disk format (flatgfa/src/file.rs:9-313): a magic-tagged
table of contents holding a (len, capacity) pair for each of the 11
pools, followed by the pools' raw bytes in a fixed order, each padded
out to its capacity. Loading is an mmap plus eleven array views. The
writer is not needed by the port and is not copied.
"""

from __future__ import annotations

import mmap
from typing import Tuple

import numpy as np

from .flatgfa import GraphArrays

MAGIC = 0xB101_1054

# Pool order and element layouts (little-endian, packed — identical to
# the reference's zerocopy structs).
SEG_DTYPE = np.dtype(
    [("name", "<u8"), ("seq", "<u4", 2), ("optional", "<u4", 2)]
)
PATH_DTYPE = np.dtype(
    [("name", "<u4", 2), ("steps", "<u4", 2), ("overlaps", "<u4", 2)]
)
LINK_DTYPE = np.dtype([("from_", "<u4"), ("to", "<u4"), ("overlap", "<u4", 2)])
SPAN_DTYPE = np.dtype([("start", "<u4"), ("end", "<u4")])

_POOL_ELEM = {
    "header": np.dtype("u1"),
    "segs": SEG_DTYPE,
    "paths": PATH_DTYPE,
    "links": LINK_DTYPE,
    "steps": np.dtype("<u4"),
    "seq_data": np.dtype("u1"),
    "overlaps": SPAN_DTYPE,
    "alignment": np.dtype("<u4"),
    "name_data": np.dtype("u1"),
    "optional_data": np.dtype("u1"),
    "line_order": np.dtype("u1"),
}

POOL_ORDER = tuple(_POOL_ELEM)

TOC_DTYPE = np.dtype(
    [("magic", "<u8")]
    + [(name, [("len", "<u8"), ("capacity", "<u8")]) for name in POOL_ORDER]
)


class FlatFileError(ValueError):
    pass


def read_pools(buf: memoryview) -> Tuple[dict, dict]:
    """Zero-copy views over each pool in a file buffer.

    Returns (pools, toc-sizes). Views alias ``buf``; nothing is copied.
    """
    if len(buf) < TOC_DTYPE.itemsize:
        raise FlatFileError("file too small for FlatGFA TOC")
    toc = np.frombuffer(buf, dtype=TOC_DTYPE, count=1)[0]
    if toc["magic"] != MAGIC:
        raise FlatFileError("bad magic number: not a FlatGFA file")

    pools = {}
    sizes = {}
    off = TOC_DTYPE.itemsize
    for name in POOL_ORDER:
        elem = _POOL_ELEM[name]
        length = int(toc[name]["len"])
        cap = int(toc[name]["capacity"])
        if length > cap or off + length * elem.itemsize > len(buf):
            raise FlatFileError("truncated FlatGFA file")
        pools[name] = np.frombuffer(buf, dtype=elem, count=length, offset=off)
        sizes[name] = (length, cap)
        off += cap * elem.itemsize
    return pools, sizes


def _arena_from_pools(pools: dict) -> GraphArrays:
    segs = pools["segs"]
    paths = pools["paths"]
    links = pools["links"]
    overlaps = pools["overlaps"]
    return GraphArrays(
        header=pools["header"],
        seg_name=segs["name"].astype(np.int64),
        seg_seq=np.ascontiguousarray(segs["seq"]),
        seg_optional=np.ascontiguousarray(segs["optional"]),
        path_name=np.ascontiguousarray(paths["name"]),
        path_steps=np.ascontiguousarray(paths["steps"]),
        path_overlaps=np.ascontiguousarray(paths["overlaps"]),
        link_from=np.ascontiguousarray(links["from_"]),
        link_to=np.ascontiguousarray(links["to"]),
        link_overlap=np.ascontiguousarray(links["overlap"]),
        steps=pools["steps"],
        seq_data=pools["seq_data"],
        overlaps=np.stack(
            [overlaps["start"], overlaps["end"]], axis=1
        ).astype(np.uint32)
        if overlaps.size
        else np.zeros((0, 2), np.uint32),
        alignment=pools["alignment"],
        name_data=pools["name_data"],
        optional_data=pools["optional_data"],
        line_order=pools["line_order"],
    )


def load_flatgfa(filename: str) -> GraphArrays:
    """mmap a binary FlatGFA file into an arena.

    The byte pools (steps, seq_data, ...) are zero-copy views over the
    mapping; the OS pages data in lazily as queries touch it.
    """
    with open(filename, "rb") as f:
        m = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    pools, _ = read_pools(memoryview(m))
    return _arena_from_pools(pools)
