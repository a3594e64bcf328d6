"""GFA text emission from the flat arena.

The port's own copy of the JAX package's emitter (pollen_tpu/emit.py
``emit_gfa``, ``emit_gfa_to_file``). Preserved order prefers the C++
emitter of :mod:`.native`; the NumPy rendering below gives the same
bytes where it is not built (or ``POLLEN_NATIVE=0``). Three orders are
supported (reference: flatgfa/src/print.rs:98-142 and mygfa's
normalized sort):

* ``preserved`` — the original file's line order, via ``line_order``;
  a parse → emit round trip is byte-identical.
* ``normalized`` — header, segments, paths, links, each in pool (id)
  order. This is what the reference's ``fgfa`` prints when the line
  order is unavailable.
* ``sorted`` — the executable spec's normalized order: segments and
  paths sorted by name *string*, links sorted by canonical text
  (what ``slow_odgi norm`` produces).

Line rendering is vectorized with NumPy string kernels: integer names are
converted with C-speed ``astype('U')`` casts and lines are assembled with
array concatenation, not per-entity Python formatting.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .flatgfa import (
    ALIGN_OPS,
    GraphArrays,
    LINE_HEADER,
    LINE_LINK,
    LINE_PATH,
    LINE_SEGMENT,
)


def _cigar_strs(g: GraphArrays, spans: np.ndarray, empty: str) -> List[str]:
    """Render each (start, end) span over the overlap pool as CIGAR text.

    ``spans`` indexes the ``overlaps`` pool (each of whose entries is a
    span over ``alignment``). An entry-less span renders as ``empty``.
    """
    out = []
    for lo, hi in spans:
        parts = []
        for e in range(lo, hi):
            alo, ahi = g.overlaps[e]
            ops = g.alignment[alo:ahi]
            if ops.size == 0:
                parts.append("0M")
            else:
                parts.append(
                    "".join(
                        f"{int(op) >> 8}{chr(ALIGN_OPS[int(op) & 0xFF])}"
                        for op in ops
                    )
                )
        out.append(",".join(parts) if parts else empty)
    return out


def segment_lines(g: GraphArrays) -> np.ndarray:
    """All S lines, in id order, as a numpy unicode array."""
    n = g.num_segments
    if n == 0:
        return np.zeros(0, dtype="U1")
    names = g.seg_name.astype("U20")
    seqs = np.array(
        [g.seq_data[lo:hi].tobytes().decode("ascii") for lo, hi in g.seg_seq],
        dtype=object,
    )
    opts = [
        "\t" + g.optional_data[lo:hi].tobytes().decode("ascii") if hi > lo else ""
        for lo, hi in g.seg_optional
    ]
    lines = np.array(
        ["S\t" + str(nm) + "\t" + sq + op for nm, sq, op in zip(names, seqs, opts)],
        dtype=object,
    )
    return lines


def _step_token_blob(g: GraphArrays) -> tuple:
    """All step tokens ("12+,34-,...") as one string plus per-token end
    offsets — a vectorized itoa (numpy's int->str astype is ~20x
    slower than digit-scatter passes at this scale)."""
    names = g.seg_name[g.step_segs]
    s = names.shape[0]
    if s == 0:
        return "", np.zeros(1, dtype=np.int64)
    # Digit counts via thresholds (names are positive integers).
    ndig = np.ones(s, dtype=np.int64)
    limit = 10
    while (names >= limit).any():
        ndig += names >= limit
        limit *= 10
    tok_len = ndig + 2  # orientation char + comma
    ends = np.cumsum(tok_len)
    buf = np.empty(int(ends[-1]), dtype=np.uint8)

    # Scatter digits, least significant first, right-aligned.
    digit_pos = ends - 3  # position of the last digit
    vals = names.copy()
    k = 0
    while True:
        live = ndig > k
        if not live.any():
            break
        buf[digit_pos[live] - k] = (vals[live] % 10 + 48).astype(np.uint8)
        vals //= 10
        k += 1
    buf[ends - 2] = np.where(g.step_reverse.astype(bool), ord("-"), ord("+"))
    buf[ends - 1] = ord(",")
    return buf.tobytes().decode("ascii"), np.concatenate(([0], ends))


def path_lines(g: GraphArrays) -> List[str]:
    """All P lines, in id order.

    Step tokens are rendered vectorized into one blob and sliced per
    path by character offset — no per-step Python work.
    """
    if g.num_paths == 0:
        return []
    blob, char_ends = _step_token_blob(g)
    olaps = _cigar_strs(g, g.path_overlaps, empty="*")
    lines = []
    for p in range(g.num_paths):
        lo, hi = g.path_steps[p]
        # Drop the trailing comma of the path's last token.
        steps_str = blob[char_ends[lo] : char_ends[hi] - 1] if hi > lo else ""
        name = g.path_name_bytes(p).decode("ascii")
        lines.append("P\t" + name + "\t" + steps_str + "\t" + olaps[p])
    return lines


def _assemble_l_lines(
    from_handles: np.ndarray, to_handles: np.ndarray, g: GraphArrays, cigars
) -> List[str]:
    """Vectorized "L\\t..\\t..\\t..\\t..\\t.." assembly."""
    parts = [
        np.full(from_handles.shape[0], "L\t", dtype="U2"),
        g.seg_name[(from_handles >> 1).astype(np.int64)].astype("U20"),
        np.where((from_handles & 1).astype(bool), "\t-\t", "\t+\t"),
        g.seg_name[(to_handles >> 1).astype(np.int64)].astype("U20"),
        np.where((to_handles & 1).astype(bool), "\t-\t", "\t+\t"),
        np.asarray(cigars, dtype="U"),
    ]
    out = parts[0]
    for part in parts[1:]:
        out = np.char.add(out, part)
    return out.tolist()


def link_lines(g: GraphArrays) -> List[str]:
    """All L lines, in id order."""
    if g.num_links == 0:
        return []
    cigars = _cigar_strs(g, g.link_overlap, empty="0M")
    return _assemble_l_lines(g.link_from, g.link_to, g, cigars)


def emit_gfa(
    g: GraphArrays,
    order: str = "preserved",
    path_sort_keys=None,
    include_links: bool = True,
) -> str:
    """Render the whole graph as GFA text.

    ``path_sort_keys`` overrides the string each path sorts by in
    ``sorted`` mode (the spec sorts ``flip`` output by the paths'
    *original*, pre-rename names). ``include_links=False`` omits L lines
    (the spec emits chop/inject results linkless).
    """
    if order == "preserved":
        # Fast path: the C++ emitter (byte-identical; falls through to
        # the NumPy path if the native library is unavailable).
        try:
            from .native import emit_gfa_native

            text = emit_gfa_native(g)
            if text is not None:
                return text
        except Exception:
            pass

    header = (
        ["H\t" + g.header.tobytes().decode("ascii")] if g.header.size else []
    )
    segs = list(segment_lines(g))
    paths = path_lines(g)
    links = link_lines(g)

    if order == "preserved":
        iters = {
            LINE_HEADER: iter(header),
            LINE_SEGMENT: iter(segs),
            LINE_PATH: iter(paths),
            LINE_LINK: iter(links),
        }
        lines = [next(iters[kind]) for kind in g.line_order]
    elif order == "normalized":
        lines = header + segs + paths + links
    elif order == "sorted":
        # The executable spec's emission order (string sort on names;
        # links by canonical text form). See spec/model.py Graph.emit.
        seg_order = np.argsort(g.seg_name.astype("U20"), kind="stable")
        if path_sort_keys is None:
            path_order = sorted(
                range(g.num_paths), key=lambda p: g.path_name_bytes(p)
            )
        else:
            path_order = sorted(
                range(g.num_paths), key=lambda p: path_sort_keys[p]
            )
        lines = (
            header
            + [segs[i] for i in seg_order]
            + [paths[i] for i in path_order]
            + (sorted(_canonical_link_lines(g)) if include_links else [])
        )
    else:
        raise ValueError(f"unknown emission order {order!r}")

    return "".join(line + "\n" for line in lines)


def emit_gfa_to_file(g: GraphArrays, path: str) -> None:
    """Write preserved-order GFA text to ``path``.

    Prefers the C++ emitter's direct-to-file path (the transform
    commands are emit-bound; this skips the Python string round trip),
    falling back to ``emit_gfa`` + write."""
    try:
        from .native import emit_gfa_file_native

        if emit_gfa_file_native(g, path):
            return
    except OSError:
        raise
    except Exception:
        pass
    with open(path, "w", encoding="ascii") as f:
        f.write(emit_gfa(g, order="preserved"))


def _canonical_link_lines(g: GraphArrays) -> List[str]:
    """L lines in the spec's canonical direction (flip when the
    destination name sorts first, or for a reversed self-link)."""
    if g.num_links == 0:
        return []
    from_seg = (g.link_from >> 1).astype(np.int64)
    to_seg = (g.link_to >> 1).astype(np.int64)
    fn = g.seg_name[from_seg].astype("U20")
    tn = g.seg_name[to_seg].astype("U20")
    f_rev = (g.link_from & 1).astype(bool)
    flip = (tn < fn) | ((fn == tn) & f_rev)

    c_from = np.where(flip, g.link_to ^ 1, g.link_from)
    c_to = np.where(flip, g.link_from ^ 1, g.link_to)
    cigars = _cigar_strs(g, g.link_overlap, empty="0M")
    return _assemble_l_lines(c_from, c_to, g, cigars)
