"""The flat GFA arena: a variation graph as a handful of flat arrays.

The port's own copy of the JAX package's arena and its NumPy parser
(pollen_tpu/flatgfa.py), so that the port imports nothing of that
package. Same schema, same parse, same errors; the JAX package's
optional C++ scanner is left out (it only parses faster, and the NumPy
parse below gives the same arena).

A variation graph *is already* a struct-of-arrays (flatgfa/src/
flatgfa.rs:19-67): eleven integer/byte pools addressed by ids and spans,
kept as literal NumPy arrays on the host, mmap-able and zero-copy.

Pools (names and element layouts match the reference binary format so the
two on-disk formats are interchangeable; see
:mod:`pollen_tpu_torch.fileformat`):

==============  =====================================================
``header``      bytes of the ``H`` line after the tab
``seg_*``       per-segment: integer name, seq span, optional-data span
``path_*``      per-path: name span, steps span, overlaps span
``link_*``      per-link: packed from/to handles, overlap span
``steps``       packed handles, one u32 per path step
``seq_data``    ASCII nucleotides, all segments concatenated
``overlaps``    (start, end) spans into ``alignment``, one per CIGAR
``alignment``   packed CIGAR ops, one u32 per op: ``(count << 8) | op``
``name_data``   path-name bytes, concatenated
``optional``    segment optional-field bytes, concatenated
``line_order``  one byte per input line for round-trip emission
==============  =====================================================

A *handle* packs an oriented segment reference into a u32:
``(seg_id << 1) | orientation`` with 0 = forward (reference:
flatgfa.rs:186-209). A CIGAR op packs as ``(count << 8) | opcode`` with
opcodes M=0, N=1, D=2, I=3 following the GFA spec (we deliberately do
*not* replicate the reference printer's D/I swap; see SURVEY.md §6).

The parser here is fully vectorized NumPy — no per-line Python loop for
the hot pools (steps, sequences).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# Line-order codes (match reference flatgfa.rs LineKind for file compat).
LINE_HEADER, LINE_SEGMENT, LINE_PATH, LINE_LINK = 0, 1, 2, 3

# CIGAR opcodes, per the GFA spec.
ALIGN_OPS = b"MNDI"
_OP_CODE = {op: i for i, op in enumerate(ALIGN_OPS)}

_TAB = 9
_NEWLINE = 10


class GFAParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Ragged-array helpers
# ---------------------------------------------------------------------------


def ragged_gather(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate ``buf[starts[i] : starts[i]+lens[i]]`` for all i.

    Few-but-large ranges (e.g. whole P-line step fields) copy fastest as
    plain slices; many-small ranges use the repeat/cumsum trick — one
    flat index vector, one fancy-gather, no Python loop.
    """
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=buf.dtype)
    if starts.shape[0] <= 64 or total > 32 * starts.shape[0]:
        return np.concatenate(
            [buf[s : s + n] for s, n in zip(starts, lens)]
        )
    offs = np.repeat(np.cumsum(lens) - lens, lens)
    idx = np.arange(total, dtype=np.int64) - offs + np.repeat(starts, lens)
    return buf[idx]


def parse_uints(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Parse many ASCII decimal integers at once.

    ``starts``/``lens`` give each number's byte range in ``buf``. Runs one
    vectorized pass per digit position (numbers here are segment names and
    CIGAR counts: short).
    """
    n = starts.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    vals = np.zeros(n, dtype=np.int64)
    width = int(lens.max())
    limit = buf.shape[0] - 1
    for k in range(width):
        live = lens > k
        digit = buf[np.minimum(starts + k, limit)].astype(np.int64) - 48
        if np.any(live & ((digit < 0) | (digit > 9))):
            raise GFAParseError("malformed integer field")
        vals = np.where(live, vals * 10 + digit, vals)
    return vals


def _spans_to_start_len(spans: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return spans[:, 0], spans[:, 1] - spans[:, 0]


# ---------------------------------------------------------------------------
# The arena
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphArrays:
    """A variation graph as flat host arrays (the FlatGFA arena)."""

    header: np.ndarray  # uint8[*]
    seg_name: np.ndarray  # int64[N]
    seg_seq: np.ndarray  # uint32[N, 2]  (start, end) into seq_data
    seg_optional: np.ndarray  # uint32[N, 2] into optional_data
    path_name: np.ndarray  # uint32[P, 2] into name_data
    path_steps: np.ndarray  # uint32[P, 2] into steps
    path_overlaps: np.ndarray  # uint32[P, 2] into overlaps
    link_from: np.ndarray  # uint32[L] packed handles
    link_to: np.ndarray  # uint32[L]
    link_overlap: np.ndarray  # uint32[L, 2] into overlaps
    steps: np.ndarray  # uint32[S] packed handles
    seq_data: np.ndarray  # uint8[B]
    overlaps: np.ndarray  # uint32[O, 2] into alignment
    alignment: np.ndarray  # uint32[A] packed ops
    name_data: np.ndarray  # uint8[*]
    optional_data: np.ndarray  # uint8[*]
    line_order: np.ndarray  # uint8[*]

    # -- basic shape info -------------------------------------------------

    @property
    def num_segments(self) -> int:
        return self.seg_name.shape[0]

    @property
    def num_paths(self) -> int:
        return self.path_name.shape[0]

    @property
    def num_links(self) -> int:
        return self.link_from.shape[0]

    @property
    def num_steps(self) -> int:
        return self.steps.shape[0]

    # -- derived views ----------------------------------------------------

    @property
    def seg_len(self) -> np.ndarray:
        """Length in bp of each segment: int64[N]."""
        return (self.seg_seq[:, 1] - self.seg_seq[:, 0]).astype(np.int64)

    @property
    def step_segs(self) -> np.ndarray:
        """Segment id of every step: int32[S]."""
        return (self.steps >> 1).astype(np.int32)

    @property
    def step_reverse(self) -> np.ndarray:
        """Orientation bit of every step (1 = reverse): uint8[S]."""
        return (self.steps & 1).astype(np.uint8)

    def step_path_ids(self) -> np.ndarray:
        """Path id owning each step: int32[S].

        The segment-id vector for path-indexed segment-sums (the
        "sequence parallel" axis of this domain).
        """
        out = np.zeros(self.num_steps, dtype=np.int32)
        starts, lens = _spans_to_start_len(self.path_steps.astype(np.int64))
        # Paths own disjoint (in practice contiguous) step spans.
        out[ragged_gather(np.arange(self.num_steps), starts, lens)] = np.repeat(
            np.arange(self.num_paths, dtype=np.int32), lens
        )
        return out

    def seg_id_by_name(self) -> "NameIndex":
        return NameIndex(self.seg_name)

    # -- entity accessors (host-side conveniences) ------------------------

    def seg_sequence(self, seg_id: int) -> bytes:
        lo, hi = self.seg_seq[seg_id]
        return self.seq_data[lo:hi].tobytes()

    def path_name_bytes(self, path_id: int) -> bytes:
        lo, hi = self.path_name[path_id]
        return self.name_data[lo:hi].tobytes()

    def path_names(self) -> List[bytes]:
        return [self.path_name_bytes(i) for i in range(self.num_paths)]

    def path_id_by_name(self, name: bytes) -> Optional[int]:
        for i in range(self.num_paths):
            if self.path_name_bytes(i) == name:
                return i
        return None

    def path_step_slice(self, path_id: int) -> np.ndarray:
        lo, hi = self.path_steps[path_id]
        return self.steps[lo:hi]

    def alignment_text(self, span: Tuple[int, int]) -> str:
        lo, hi = span
        ops = self.alignment[lo:hi]
        return "".join(
            f"{int(op) >> 8}{chr(ALIGN_OPS[int(op) & 0xFF])}" for op in ops
        )

    def validate_invariants(self) -> None:
        """Cheap structural sanity checks (debug aid)."""
        if self.num_steps:
            assert int(self.step_segs.max()) < self.num_segments
        if self.num_links:
            assert int(max(self.link_from.max(), self.link_to.max()) >> 1) < (
                self.num_segments
            )
        assert (self.seg_seq[:, 1] >= self.seg_seq[:, 0]).all()


class NameIndex:
    """Segment name -> id lookup with a sequential fast path.

    Mirrors the reference's NameMap trick (reference: namemap.rs:7-42):
    graphs in the wild almost always name segments 1..N in order, which
    makes lookup pure arithmetic; otherwise fall back to sorted search.
    """

    def __init__(self, names: np.ndarray):
        self._names = names
        n = names.shape[0]
        self.sequential = bool(
            n > 0 and names[0] == 1 and (np.diff(names) == 1).all()
        ) or n == 0
        if not self.sequential:
            self._order = np.argsort(names, kind="stable")
            self._sorted = names[self._order]

    def lookup(self, queries: np.ndarray) -> np.ndarray:
        """Map an int64 array of names to segment ids (int32)."""
        if self.sequential:
            ids = queries - 1
            if queries.size and (
                ids.min() < 0 or ids.max() >= self._names.shape[0]
            ):
                raise GFAParseError("unknown segment name")
            return ids.astype(np.int32)
        pos = np.searchsorted(self._sorted, queries)
        pos = np.clip(pos, 0, self._sorted.shape[0] - 1)
        if queries.size and not (self._sorted[pos] == queries).all():
            raise GFAParseError("unknown segment name")
        return self._order[pos].astype(np.int32)


# ---------------------------------------------------------------------------
# Vectorized text parser
# ---------------------------------------------------------------------------


def _line_table(buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split a byte buffer into (line_start, line_end) pairs, dropping
    blank lines. Ends exclude the newline."""
    newlines = np.flatnonzero(buf == _NEWLINE)
    starts = np.concatenate(([0], newlines + 1))
    ends = np.concatenate((newlines, [buf.shape[0]]))
    keep = ends > starts
    return starts[keep], ends[keep]


def _tab_table(
    buf: np.ndarray, starts: np.ndarray, ends: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """All tab positions, plus for each line the offset of its first tab
    in the tab array. Lets callers fetch "the k-th tab of line i" as
    ``tabs[tab_offset[i] + k]`` with pure array math."""
    tabs = np.flatnonzero(buf == _TAB)
    tab_offset = np.searchsorted(tabs, starts)
    return tabs, tab_offset


def _kth_tab(
    tabs: np.ndarray, tab_offset: np.ndarray, k: int, ends: np.ndarray
) -> np.ndarray:
    """Position of the k-th (0-based) tab of each line; lines with fewer
    tabs get their end position instead."""
    idx = tab_offset + k
    pos = tabs[np.minimum(idx, tabs.shape[0] - 1)] if tabs.size else ends.copy()
    if tabs.size:
        pos = np.where(idx < tabs.shape[0], pos, ends)
    return np.minimum(pos, ends)


def _parse_cigar_pool(
    buf: np.ndarray, starts: np.ndarray, ends: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Parse many CIGAR strings at once.

    Returns the packed alignment pool (u32 per op) and a (start, end) span
    per input string. ``*`` parses as an empty alignment.
    """
    n = starts.shape[0]
    if n == 0:
        return np.zeros(0, np.uint32), np.zeros((0, 2), np.uint32)

    lens = ends - starts
    text = ragged_gather(buf, starts, lens)
    str_of_char = np.repeat(np.arange(n), lens)
    bounds = np.cumsum(lens) - lens  # start of each string in `text`

    is_op = (
        (text == ord("M"))
        | (text == ord("N"))
        | (text == ord("D"))
        | (text == ord("I"))
    )
    op_pos = np.flatnonzero(is_op)
    op_str = str_of_char[op_pos]  # which input string each op ends

    # The count for an op runs from just after the previous op (or the
    # string start) up to the op letter.
    prev_op = np.concatenate(([-1], op_pos[:-1]))
    same_str = np.concatenate(([False], op_str[1:] == op_str[:-1]))
    num_start = np.where(same_str, prev_op + 1, bounds[op_str])
    counts = parse_uints(text, num_start, op_pos - num_start)

    codes = np.zeros(op_pos.shape[0], dtype=np.uint32)
    for op, code in _OP_CODE.items():
        codes[text[op_pos] == op] = code
    pool = (counts.astype(np.uint32) << np.uint32(8)) | codes

    # Ops per string -> span per string.
    per_str = np.bincount(op_str, minlength=n)
    span_end = np.cumsum(per_str)
    spans = np.stack([span_end - per_str, span_end], axis=1).astype(np.uint32)

    # Validate: everything that isn't a digit or op letter must be a '*'
    # (and then the string must be exactly "*").
    is_digit = (text >= 48) & (text <= 57)
    stray = ~(is_digit | is_op) & (text != ord("*"))
    if stray.any():
        raise GFAParseError("malformed CIGAR string")
    return pool, spans


def parse_gfa(data: bytes, native: bool = True) -> GraphArrays:
    """Parse GFA text into a :class:`GraphArrays` arena.

    Tries the C++ single-pass scanner first (:mod:`.native`), then
    falls back to this vectorized two-pass NumPy build (semantics follow
    the reference parser, flatgfa/src/parse.rs:24-126): segments are
    ingested first so that links and paths — which may reference
    segments defined later in the file — resolve against the complete
    name table. The scanner gives identical arrays; where it rejects a
    corner of the grammar, the NumPy path gives the real diagnostics.
    """
    if native:
        try:
            from .native import parse_gfa_native

            result = parse_gfa_native(data)
            if result is not None:
                return result
        except Exception:
            pass  # any native hiccup falls back to the NumPy path

    try:
        return _parse_gfa_numpy(data)
    except GFAParseError:
        raise
    except (ValueError, IndexError) as exc:
        # Malformed field structure trips array shape checks before the
        # explicit validations do; surface it as a parse error.
        raise GFAParseError(f"malformed GFA structure: {exc}") from exc


@dataclasses.dataclass
class DeferredArrays:
    """One byte range's pools with *unresolved* segment references.

    The range-local output of phase-1 parsing: links and path steps
    still carry raw segment names (they may reference segments defined
    in a different range — the two-pass defer of the reference parser,
    flatgfa/src/parse.rs:24-126, generalized across byte ranges). All
    spans are relative to this range's own pools, so deferred ranges
    concatenate with plain offset fixups (:func:`merge_resolved`).
    """

    header: np.ndarray  # uint8[*]
    line_order: np.ndarray  # uint8[*]
    # Segments.
    seg_name: np.ndarray  # int64[N]
    seg_seq: np.ndarray  # uint32[N, 2] into seq_data
    seq_data: np.ndarray  # uint8[*]
    seg_optional: np.ndarray  # uint32[N, 2] into optional_data
    optional_data: np.ndarray  # uint8[*]
    # Links (raw names; resolved by :func:`resolve_deferred`).
    from_names: np.ndarray  # int64[L]
    from_rev: np.ndarray  # bool[L]
    to_names: np.ndarray  # int64[L]
    to_rev: np.ndarray  # bool[L]
    link_cig_pool: np.ndarray  # uint32[*] packed ops
    link_cig_spans: np.ndarray  # uint32[L, 2] into link_cig_pool
    # Paths (raw step names).
    path_name: np.ndarray  # uint32[P, 2] into name_data
    name_data: np.ndarray  # uint8[*]
    step_names: np.ndarray  # int64[S]
    step_rev: np.ndarray  # uint32[S]
    steps_per_path: np.ndarray  # int64[P]
    path_cig_pool: np.ndarray  # uint32[*]
    path_cig_entry_spans: np.ndarray  # uint32[E, 2] into path_cig_pool
    path_overlap_spans: np.ndarray  # uint32[P, 2] entry spans per path


@dataclasses.dataclass
class ResolvedArrays:
    """A deferred range with its segment references resolved to global
    ids (phase-2 output; still range-local spans)."""

    d: DeferredArrays
    link_from: np.ndarray  # uint32[L] packed handles
    link_to: np.ndarray  # uint32[L]
    steps: np.ndarray  # uint32[S] packed handles


def _parse_gfa_deferred(data: bytes) -> DeferredArrays:
    """Phase 1: parse one byte range's lines into range-local pools.

    Pure local work — no segment name table needed; in a multi-host job
    every host runs this over only its own range."""
    buf = np.frombuffer(data, dtype=np.uint8)
    starts, ends = _line_table(buf)
    kinds = buf[starts] if starts.size else np.zeros(0, np.uint8)

    is_h = kinds == ord("H")
    is_s = kinds == ord("S")
    is_l = kinds == ord("L")
    is_p = kinds == ord("P")
    if not (is_h | is_s | is_l | is_p).all():
        bad = kinds[~(is_h | is_s | is_l | is_p)][0]
        raise GFAParseError(f"unknown GFA line kind {chr(bad)!r}")

    line_order = np.zeros(starts.shape[0], dtype=np.uint8)
    line_order[is_h] = LINE_HEADER
    line_order[is_s] = LINE_SEGMENT
    line_order[is_p] = LINE_PATH
    line_order[is_l] = LINE_LINK

    tabs, tab_offset = _tab_table(buf, starts, ends)

    # -- header -----------------------------------------------------------
    h_starts, h_ends = starts[is_h], ends[is_h]
    if h_starts.shape[0] > 1:
        raise GFAParseError("multiple header lines")
    if h_starts.shape[0] == 1:
        header = buf[h_starts[0] + 2 : h_ends[0]].copy()
    else:
        header = np.zeros(0, dtype=np.uint8)

    # -- segments ---------------------------------------------------------
    s_sel = np.flatnonzero(is_s)
    s_starts, s_ends = starts[s_sel], ends[s_sel]
    s_off = tab_offset[s_sel]
    t1 = _kth_tab(tabs, s_off, 1, s_ends)  # after name
    t2 = _kth_tab(tabs, s_off, 2, s_ends)  # after seq (or line end)
    name_lo = s_starts + 2
    seg_name = parse_uints(buf, name_lo, t1 - name_lo)

    seq_lo, seq_hi = t1 + 1, t2
    seq_lens = seq_hi - seq_lo
    seq_data = ragged_gather(buf, seq_lo, seq_lens)
    seq_end = np.cumsum(seq_lens)
    seg_seq = np.stack([seq_end - seq_lens, seq_end], axis=1).astype(np.uint32)

    opt_lo = np.minimum(t2 + 1, s_ends)
    opt_lens = s_ends - opt_lo
    optional_data = ragged_gather(buf, opt_lo, opt_lens)
    opt_end = np.cumsum(opt_lens)
    seg_optional = np.stack([opt_end - opt_lens, opt_end], axis=1).astype(
        np.uint32
    )

    # -- links (names stay raw) -------------------------------------------
    l_sel = np.flatnonzero(is_l)
    l_starts, l_ends = starts[l_sel], ends[l_sel]
    l_off = tab_offset[l_sel]
    lt = [_kth_tab(tabs, l_off, k, l_ends) for k in range(1, 6)]

    from_names = parse_uints(buf, l_starts + 2, lt[0] - (l_starts + 2))
    from_ori = buf[np.minimum(lt[0] + 1, buf.shape[0] - 1)] if l_sel.size else np.zeros(0, np.uint8)
    to_names = parse_uints(buf, lt[1] + 1, lt[2] - (lt[1] + 1))
    to_ori = buf[np.minimum(lt[2] + 1, buf.shape[0] - 1)] if l_sel.size else np.zeros(0, np.uint8)
    for ori in (from_ori, to_ori):
        if ori.size and not ((ori == ord("+")) | (ori == ord("-"))).all():
            raise GFAParseError("bad link orientation")

    link_cig_pool, link_cig_spans = _parse_cigar_pool(
        buf, lt[3] + 1, l_ends
    )

    # -- paths (step names stay raw) --------------------------------------
    p_sel = np.flatnonzero(is_p)
    p_starts, p_ends = starts[p_sel], ends[p_sel]
    p_off = tab_offset[p_sel]
    pt1 = _kth_tab(tabs, p_off, 1, p_ends)
    pt2 = _kth_tab(tabs, p_off, 2, p_ends)
    pt3 = _kth_tab(tabs, p_off, 3, p_ends)

    pname_lo = p_starts + 2
    pname_lens = pt1 - pname_lo
    name_data = ragged_gather(buf, pname_lo, pname_lens)
    pname_end = np.cumsum(pname_lens)
    path_name = np.stack([pname_end - pname_lens, pname_end], axis=1).astype(
        np.uint32
    )

    # Steps: parse all paths' step fields as one concatenated token stream.
    steps_lo, steps_hi = pt1 + 1, pt2
    steps_lens = steps_hi - steps_lo
    steps_text = ragged_gather(buf, steps_lo, steps_lens)
    path_of_char = np.repeat(np.arange(p_sel.shape[0]), steps_lens)

    is_ori = (steps_text == ord("+")) | (steps_text == ord("-"))
    ori_pos = np.flatnonzero(is_ori)
    step_path = path_of_char[ori_pos] if ori_pos.size else ori_pos
    char_bounds = np.cumsum(steps_lens) - steps_lens

    prev_end = np.concatenate(([-1], ori_pos[:-1]))
    same_path = np.concatenate(
        ([False], step_path[1:] == step_path[:-1])
    ) if ori_pos.size else np.zeros(0, bool)
    # Token starts just after the previous token's comma, or at the path
    # field start.
    tok_start = np.where(
        same_path, prev_end + 2, char_bounds[step_path] if ori_pos.size else prev_end
    )
    step_names = parse_uints(steps_text, tok_start, ori_pos - tok_start)
    step_rev = (steps_text[ori_pos] == ord("-")).astype(np.uint32)

    steps_per_path = (
        np.bincount(step_path, minlength=p_sel.shape[0])
        if ori_pos.size
        else np.zeros(p_sel.shape[0], np.int64)
    )

    # Path overlaps ('*' or a comma-separated CIGAR list). We parse each
    # path's whole overlap field as one CIGAR string (commas are just
    # separators between ops for span purposes) but must count entries.
    ov_lo, ov_hi = pt2 + 1, pt3
    path_cig_pool, path_cig_entry_spans, path_overlap_spans = (
        _parse_path_overlaps(buf, ov_lo, ov_hi)
    )

    return DeferredArrays(
        header=header,
        line_order=line_order,
        seg_name=seg_name,
        seg_seq=seg_seq,
        seq_data=seq_data,
        seg_optional=seg_optional,
        optional_data=optional_data,
        from_names=from_names,
        from_rev=from_ori == ord("-"),
        to_names=to_names,
        to_rev=to_ori == ord("-"),
        link_cig_pool=link_cig_pool,
        link_cig_spans=link_cig_spans,
        path_name=path_name,
        name_data=name_data,
        step_names=step_names,
        step_rev=step_rev,
        steps_per_path=steps_per_path,
        path_cig_pool=path_cig_pool,
        path_cig_entry_spans=path_cig_entry_spans,
        path_overlap_spans=path_overlap_spans,
    )


def resolve_deferred(d: DeferredArrays, names: "NameIndex") -> ResolvedArrays:
    """Phase 2: resolve one range's raw segment names against the
    *global* name table (local work: O(this range's links + steps))."""
    link_from = (
        (names.lookup(d.from_names).astype(np.uint32) << np.uint32(1))
        | d.from_rev.astype(np.uint32)
    )
    link_to = (
        (names.lookup(d.to_names).astype(np.uint32) << np.uint32(1))
        | d.to_rev.astype(np.uint32)
    )
    steps = (
        names.lookup(d.step_names).astype(np.uint32) << np.uint32(1)
    ) | d.step_rev.astype(np.uint32)
    return ResolvedArrays(d=d, link_from=link_from, link_to=link_to, steps=steps)


def _offset_spans(spans_list, sizes) -> np.ndarray:
    """Concatenate span arrays, shifting each by its pool's offset."""
    offsets = np.concatenate(([0], np.cumsum(sizes[:-1]))) if sizes else []
    parts = [
        s.astype(np.uint64) + np.uint64(off)
        for s, off in zip(spans_list, offsets)
    ]
    return (
        np.concatenate(parts, axis=0).astype(np.uint32)
        if parts
        else np.zeros((0, 2), np.uint32)
    )


def merge_resolved(ranges: List[ResolvedArrays]) -> GraphArrays:
    """Assemble resolved ranges into one arena: pure concatenation with
    span-offset fixups — byte-identical to a single-process parse of the
    whole file (ids are assigned in file order either way)."""
    ds = [r.d for r in ranges]
    header = next((d.header for d in ds if d.header.size), np.zeros(0, np.uint8))

    cat = np.concatenate
    seq_sizes = [d.seq_data.shape[0] for d in ds]
    opt_sizes = [d.optional_data.shape[0] for d in ds]
    name_sizes = [d.name_data.shape[0] for d in ds]
    lpool_sizes = [d.link_cig_pool.shape[0] for d in ds]
    ppool_sizes = [d.path_cig_pool.shape[0] for d in ds]
    pentry_sizes = [d.path_cig_entry_spans.shape[0] for d in ds]

    seg_seq = _offset_spans([d.seg_seq for d in ds], seq_sizes)
    seg_optional = _offset_spans([d.seg_optional for d in ds], opt_sizes)
    path_name = _offset_spans([d.path_name for d in ds], name_sizes)
    link_cig_spans = _offset_spans([d.link_cig_spans for d in ds], lpool_sizes)
    path_cig_entry_spans = _offset_spans(
        [d.path_cig_entry_spans for d in ds], ppool_sizes
    )
    path_overlap_spans = _offset_spans(
        [d.path_overlap_spans for d in ds], pentry_sizes
    )

    steps_per_path = cat([d.steps_per_path for d in ds])
    sp_end = np.cumsum(steps_per_path)
    path_steps = np.stack([sp_end - steps_per_path, sp_end], axis=1).astype(
        np.uint32
    )

    # -- merge alignment pools (links first, then paths) -------------------
    link_cig_pool = cat([d.link_cig_pool for d in ds])
    path_cig_pool = cat([d.path_cig_pool for d in ds])
    alignment = cat([link_cig_pool, path_cig_pool])
    path_cig_entry_spans = path_cig_entry_spans + np.uint32(
        link_cig_pool.shape[0]
    )
    # Overlap pool: one span per link CIGAR, then per path CIGAR entry.
    overlaps = cat(
        [link_cig_spans, path_cig_entry_spans], axis=0
    ).astype(np.uint32)
    nl = link_cig_spans.shape[0]
    link_overlap = np.stack(
        [np.arange(nl, dtype=np.uint32), np.arange(1, nl + 1, dtype=np.uint32)],
        axis=1,
    )
    path_overlaps = (path_overlap_spans + np.uint32(nl)).astype(np.uint32)

    return GraphArrays(
        header=header,
        seg_name=cat([d.seg_name for d in ds]),
        seg_seq=seg_seq,
        seg_optional=seg_optional,
        path_name=path_name,
        path_steps=path_steps,
        path_overlaps=path_overlaps,
        link_from=cat([r.link_from for r in ranges]),
        link_to=cat([r.link_to for r in ranges]),
        link_overlap=link_overlap,
        steps=cat([r.steps for r in ranges]),
        seq_data=cat([d.seq_data for d in ds]),
        overlaps=overlaps,
        alignment=alignment,
        name_data=cat([d.name_data for d in ds]),
        optional_data=cat([d.optional_data for d in ds]),
        line_order=cat([d.line_order for d in ds]),
    )


def _parse_gfa_numpy(data: bytes) -> GraphArrays:
    d = _parse_gfa_deferred(data)
    names = NameIndex(d.seg_name)
    return merge_resolved([resolve_deferred(d, names)])


def _parse_path_overlaps(
    buf: np.ndarray, starts: np.ndarray, ends: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse the overlap column of many P lines.

    Returns (packed op pool, (start, end) span per CIGAR entry,
    (start, end) span-of-entries per path). A ``*`` column contributes no
    entries.
    """
    n = starts.shape[0]
    if n == 0:
        return (
            np.zeros(0, np.uint32),
            np.zeros((0, 2), np.uint32),
            np.zeros((0, 2), np.uint32),
        )

    lens = ends - starts
    text = ragged_gather(buf, starts, lens)
    path_of_char = np.repeat(np.arange(n), lens)
    bounds = np.cumsum(lens) - lens

    # Entries are comma-separated within a path's column; a `*` column
    # contains no op letters and so contributes no entries.
    is_comma = text == ord(",")
    is_op = (
        (text == ord("M"))
        | (text == ord("N"))
        | (text == ord("D"))
        | (text == ord("I"))
    )
    op_pos = np.flatnonzero(is_op)
    op_path = path_of_char[op_pos]

    prev = np.concatenate(([-1], op_pos[:-1]))
    same = np.concatenate(([False], op_path[1:] == op_path[:-1])) if op_pos.size else np.zeros(0, bool)
    num_start = np.where(same, prev + 1, bounds[op_path] if op_pos.size else prev)
    # Skip a separating comma if present at the op's number start.
    if op_pos.size:
        at_comma = text[np.minimum(num_start, text.shape[0] - 1)] == ord(",")
        num_start = num_start + at_comma.astype(np.int64)
    counts = parse_uints(text, num_start, op_pos - num_start)
    codes = np.zeros(op_pos.shape[0], dtype=np.uint32)
    for op, code in _OP_CODE.items():
        codes[text[op_pos] == op] = code
    pool = (counts.astype(np.uint32) << np.uint32(8)) | codes

    # Each CIGAR entry = run of ops between commas within one path.
    # Entry id changes at a comma or a path boundary.
    if op_pos.size:
        prev_comma = np.cumsum(is_comma)[op_pos]  # commas before each op
        entry_key = op_path.astype(np.int64) * (int(prev_comma.max()) + 2) + prev_comma
        new_entry = np.concatenate(([True], entry_key[1:] != entry_key[:-1]))
        entry_ids = np.cumsum(new_entry) - 1
        num_entries = int(entry_ids[-1]) + 1
        ops_per_entry = np.bincount(entry_ids, minlength=num_entries)
        e_end = np.cumsum(ops_per_entry)
        entry_spans = np.stack([e_end - ops_per_entry, e_end], axis=1).astype(
            np.uint32
        )
        entry_path = op_path[np.flatnonzero(new_entry)]
        entries_per_path = np.bincount(entry_path, minlength=n)
    else:
        entry_spans = np.zeros((0, 2), np.uint32)
        entries_per_path = np.zeros(n, np.int64)

    p_end = np.cumsum(entries_per_path)
    path_spans = np.stack([p_end - entries_per_path, p_end], axis=1).astype(
        np.uint32
    )
    return pool, entry_spans, path_spans


def parse_gfa_file(filename: str) -> GraphArrays:
    """Parse a GFA text file (reads via mmap when possible)."""
    import mmap

    with open(filename, "rb") as f:
        try:
            with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
                return parse_gfa(bytes(m))
        except ValueError:  # empty file
            return parse_gfa(b"")
