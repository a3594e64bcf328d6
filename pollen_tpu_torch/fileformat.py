"""The FlatGFA binary file format (``fgfa-torch -i``, ``-o``, ``-m``).

The port's own copy of the JAX package's file format
(pollen_tpu/fileformat.py: ``load_flatgfa``, ``save_flatgfa``,
``update_in_place``), byte-compatible with the reference's on-disk
format (flatgfa/src/file.rs:9-313): a magic-tagged table of contents
holding a (len, capacity) pair for each of the 11 pools, followed by
the pools' raw bytes in a fixed order, each padded out to its capacity.
Loading is an mmap plus eleven array views. Capacity > len leaves
spare room so a file can be rewritten in place (``-m``).
"""

from __future__ import annotations

import mmap
import os
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


def _pools_of(g: GraphArrays) -> dict:
    """Assemble the 11 pool arrays (in file element layouts) from an arena."""
    segs = np.zeros(g.num_segments, dtype=SEG_DTYPE)
    segs["name"] = g.seg_name.astype(np.uint64)
    segs["seq"] = g.seg_seq
    segs["optional"] = g.seg_optional

    paths = np.zeros(g.num_paths, dtype=PATH_DTYPE)
    paths["name"] = g.path_name
    paths["steps"] = g.path_steps
    paths["overlaps"] = g.path_overlaps

    links = np.zeros(g.num_links, dtype=LINK_DTYPE)
    links["from_"] = g.link_from
    links["to"] = g.link_to
    links["overlap"] = g.link_overlap

    overlaps = np.zeros(g.overlaps.shape[0], dtype=SPAN_DTYPE)
    if overlaps.size:
        overlaps["start"] = g.overlaps[:, 0]
        overlaps["end"] = g.overlaps[:, 1]

    return {
        "header": g.header,
        "segs": segs,
        "paths": paths,
        "links": links,
        "steps": g.steps.astype("<u4"),
        "seq_data": g.seq_data,
        "overlaps": overlaps,
        "alignment": g.alignment.astype("<u4"),
        "name_data": g.name_data,
        "optional_data": g.optional_data,
        "line_order": g.line_order,
    }


def save_flatgfa(filename: str, g: GraphArrays, spare: float = 0.0) -> None:
    """Write an arena to a binary FlatGFA file.

    ``spare`` reserves extra capacity per pool (fraction of len) for
    later in-place rewrites.
    """
    pools = _pools_of(g)
    toc = np.zeros((), dtype=TOC_DTYPE)
    toc["magic"] = MAGIC
    total = TOC_DTYPE.itemsize
    caps = {}
    for name, arr in pools.items():
        cap = arr.shape[0] + int(arr.shape[0] * spare)
        caps[name] = cap
        toc[name]["len"] = arr.shape[0]
        toc[name]["capacity"] = cap
        total += cap * _POOL_ELEM[name].itemsize

    with open(filename, "wb") as f:
        f.truncate(total)
        f.write(toc.tobytes())
        for name, arr in pools.items():
            f.write(arr.tobytes())
            pad = (caps[name] - arr.shape[0]) * _POOL_ELEM[name].itemsize
            if pad:
                f.seek(pad, os.SEEK_CUR)
        f.truncate(total)


def update_in_place(filename: str, g: GraphArrays) -> None:
    """Rewrite an existing FlatGFA file's pools in place.

    The file's pool *capacities* are kept; each new pool must fit within
    its existing capacity (the reference's mutate-in-place mode, file.rs
    view_store / cli -m). Raises FlatFileError when a pool outgrew its
    slot.
    """
    pools = _pools_of(g)
    with open(filename, "r+b") as f:
        head = f.read(TOC_DTYPE.itemsize)
        if len(head) < TOC_DTYPE.itemsize:
            raise FlatFileError("file too small for FlatGFA TOC")
        toc = np.frombuffer(head, dtype=TOC_DTYPE).copy()[0]
        if toc["magic"] != MAGIC:
            raise FlatFileError("bad magic number: not a FlatGFA file")

        off = TOC_DTYPE.itemsize
        writes = []
        for name in POOL_ORDER:
            arr = pools[name]
            cap = int(toc[name]["capacity"])
            if arr.shape[0] > cap:
                raise FlatFileError(
                    f"pool {name!r} needs {arr.shape[0]} slots but the "
                    f"file only reserves {cap}; rewrite with save_flatgfa"
                )
            toc[name]["len"] = arr.shape[0]
            writes.append((off, arr))
            off += cap * _POOL_ELEM[name].itemsize

        f.seek(0)
        f.write(toc.tobytes())
        for pos, arr in writes:
            f.seek(pos)
            f.write(arr.tobytes())


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


def load_flatgfa_bytes(data: bytes) -> GraphArrays:
    """An arena over a FlatGFA file's bytes held in memory (views alias
    ``data``)."""
    pools, _ = read_pools(memoryview(data))
    return _arena_from_pools(pools)
