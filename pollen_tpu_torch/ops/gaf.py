"""GAF (alignment) support: read parsing, path chunking, pangenotype.

A port of pollen_tpu/ops/gaf.py (reference semantics:
flatgfa/src/ops/gaf.rs and ops/pangenotype.rs). A GAF line carries a
read name, a path through the graph (``>12<34``), and the bp interval
[start, end) of the read along that path; the *chunker* walks the path
and classifies each step as skipped, fully covered, or partially
covered with clipped offsets.

The parser, the windowed stream (with its spawned parse workers), the
text renderings and the pangenotype matrix are host numpy, copied. The
chunk classification for *all* reads of a window is plain torch on the
graph's device (:func:`chunk_reads`): an int64 prefix sum of step
lengths, each read's base offset gathered from its first step, and
elementwise interval logic, instead of the reference's per-read
iterator. A segment name absent from the graph raises
``GFAParseError`` in the parse, before anything reaches the device.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Tuple

import numpy as np

from ..flatgfa import GraphArrays, NameIndex, parse_uints, ragged_gather

# Spawned parse workers import this module: torch is imported only by
# the functions that reach the device, so that a worker's start-up is
# numpy's, not torch's.
if TYPE_CHECKING:
    import torch

    from ..device import TorchGraph

_NEWLINE = 10
_TAB = 9

# Chunk-range kinds.
KIND_NONE, KIND_ALL, KIND_PARTIAL = 0, 1, 2


@dataclasses.dataclass
class GafReads:
    """All reads of a GAF file, flattened."""

    name_data: np.ndarray  # uint8[*]
    name_span: np.ndarray  # uint32[R, 2]
    start: np.ndarray  # int64[R]
    end: np.ndarray  # int64[R]
    steps: np.ndarray  # uint32[T] packed handles, all reads concatenated
    read_bounds: np.ndarray  # int64[R+1] spans into steps

    @property
    def num_reads(self) -> int:
        return self.start.shape[0]

    def read_name(self, i: int) -> bytes:
        lo, hi = self.name_span[i]
        return self.name_data[lo:hi].tobytes()


def parse_gaf(data: bytes, names: NameIndex) -> GafReads:
    """Vectorized GAF parser (reference: gaf.rs GAFLineParser).

    Fields used: 0 = read name, 5 = path, 7 = start, 8 = end.
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    newlines = np.flatnonzero(buf == _NEWLINE)
    starts = np.concatenate(([0], newlines + 1))
    ends = np.concatenate((newlines, [buf.shape[0]]))
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]

    if starts.size == 0:
        return GafReads(
            np.zeros(0, np.uint8),
            np.zeros((0, 2), np.uint32),
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            np.zeros(0, np.uint32),
            np.zeros(1, np.int64),
        )

    tabs = np.flatnonzero(buf == _TAB)
    off = np.searchsorted(tabs, starts)

    def kth(k):
        idx = off + k
        pos = tabs[np.minimum(idx, tabs.shape[0] - 1)]
        pos = np.where(idx < tabs.shape[0], pos, ends)
        return np.minimum(pos, ends)

    t = [kth(k) for k in range(9)]
    name_lens = t[0] - starts
    name_data = ragged_gather(buf, starts, name_lens)
    n_end = np.cumsum(name_lens)
    name_span = np.stack([n_end - name_lens, n_end], axis=1).astype(np.uint32)

    lo = parse_uints(buf, t[6] + 1, t[7] - (t[6] + 1))
    hi = parse_uints(buf, t[7] + 1, t[8] - (t[7] + 1))

    # Path strings: parse `>12<34` tokens across all reads at once.
    p_lo, p_hi = t[4] + 1, t[5]
    p_lens = p_hi - p_lo
    text = ragged_gather(buf, p_lo, p_lens)
    # int32 per-char ids: halves the biggest streaming-parse temporary.
    read_of_char = np.repeat(
        np.arange(starts.shape[0], dtype=np.int32), p_lens
    )

    is_dir = (text == ord(">")) | (text == ord("<"))
    dir_pos = np.flatnonzero(is_dir)
    tok_read = read_of_char[dir_pos]
    next_dir = np.concatenate(
        (dir_pos[1:], [text.shape[0]])
    )
    char_bounds = np.cumsum(p_lens)
    read_char_end = char_bounds[tok_read]
    num_end = np.minimum(next_dir, read_char_end)
    seg_names = parse_uints(text, dir_pos + 1, num_end - (dir_pos + 1))
    rev = (text[dir_pos] == ord("<")).astype(np.uint32)
    steps = (
        names.lookup(seg_names).astype(np.uint32) << np.uint32(1)
    ) | rev

    per_read = np.bincount(tok_read, minlength=starts.shape[0])
    read_bounds = np.concatenate(([0], np.cumsum(per_read))).astype(np.int64)

    return GafReads(
        name_data=name_data,
        name_span=name_span,
        start=lo,
        end=hi,
        steps=steps,
        read_bounds=read_bounds,
    )


def parse_gaf_file(filename: str, g: GraphArrays) -> GafReads:
    with open(filename, "rb") as f:
        return parse_gaf(f.read(), g.seg_id_by_name())


# Streaming window size: keeps memory O(window) for multi-GB read sets
# (reference analogue: gaf.rs:73-103's mmap iterator / rayon stream).
# Small windows are also FASTER: the vectorized parser's per-char
# temporaries fit cache (measured 54.6 MB/s at 1 MB vs 4.6 MB/s at the
# old 64 MB on a 2-core host; the sweep is in docs/benchmarks.md).
DEFAULT_GAF_WINDOW = 2 << 20


def _iter_gaf_blocks(filename: str, window_bytes: int):
    """Yield newline-aligned byte windows of ~window_bytes each."""
    with open(filename, "rb") as f:
        carry = b""
        while True:
            block = f.read(window_bytes)
            if not block:
                if carry.strip():
                    yield carry
                return
            data = carry + block
            cut = data.rfind(b"\n")
            if cut < 0:
                carry = data
                continue
            yield data[: cut + 1]
            carry = data[cut + 1 :]


def default_gaf_workers() -> int:
    """Worker processes for parallel GAF parsing (reference analogue:
    the rayon ParallelIterator over GAFParser, gaf.rs:93-103).
    POLLEN_GAF_WORKERS overrides; default = CPU count."""
    import os

    v = os.environ.get("POLLEN_GAF_WORKERS")
    if v is not None:
        return max(1, int(v))
    return max(1, os.cpu_count() or 1)


# Per-worker parse state: the NameIndex ships once at pool startup
# (initializer), not once per window.
_WORKER_NAMES: dict = {}


def _gaf_worker_init(names: NameIndex) -> None:
    _WORKER_NAMES["names"] = names


def _gaf_worker_parse(block: bytes) -> GafReads:
    return parse_gaf(block, _WORKER_NAMES["names"])


def iter_gaf_windows(
    filename: str,
    names: NameIndex,
    window_bytes: int = DEFAULT_GAF_WINDOW,
    workers: int | None = None,
):
    """Yield :class:`GafReads` batches, one per ~window_bytes of file.

    Lines never straddle windows (the tail past the last newline
    carries into the next window), so every yielded batch is a
    self-contained set of reads and peak memory stays O(window) no
    matter the file size.

    Multi-window files parse in parallel across ``workers`` processes
    (shard + ordered merge, the same structure as the native GFA
    scanner's phase split and the reference's rayon GAFParser,
    gaf.rs:93-103): a bounded number of in-flight windows keeps memory
    O(workers * window) while results yield in file order. Single-
    window files skip the pool entirely. The numpy parser holds the
    GIL, so threads do not help — worker processes are spawned (never
    forked: the parent may hold an initialized CUDA context). Workers
    only parse: they never touch the device.
    """
    auto = workers is None
    if auto:
        workers = default_gaf_workers()
    import os

    # Worker startup costs seconds each (spawn re-imports this module
    # and torch with it); it only amortizes past a few hundred MB of
    # file. An explicit ``workers`` request always gets the pool.
    small = os.path.getsize(filename) <= max(4 * window_bytes, 256 << 20)
    if workers <= 1 or (auto and small):
        for block in _iter_gaf_blocks(filename, window_bytes):
            yield parse_gaf(block, names)
        return

    import multiprocessing as mp
    from collections import deque
    from concurrent.futures import ProcessPoolExecutor

    ctx = mp.get_context("spawn")
    ex = ProcessPoolExecutor(
        workers,
        mp_context=ctx,
        initializer=_gaf_worker_init,
        initargs=(names,),
    )
    try:
        pending: deque = deque()
        for block in _iter_gaf_blocks(filename, window_bytes):
            pending.append(ex.submit(_gaf_worker_parse, block))
            while len(pending) > workers:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        # A consumer abandoning the generator mid-iteration raises
        # GeneratorExit here; a context-managed __exit__ would then
        # BLOCK on every in-flight window (~2 s spawn + parse each).
        # Cancel what never started and return without waiting.
        ex.shutdown(wait=False, cancel_futures=True)


# ---------------------------------------------------------------------------
# Batched chunker (reference: gaf.rs PathChunker::next)
# ---------------------------------------------------------------------------


def _read_base(pos_global, read_id, n_reads: int):
    """pos_global at each step's read's first step. The reference
    carries it forward with a running max scan over read-start markers;
    here each read's first step index is scattered to its read (the
    other steps to a spare slot) and gathered back: ``torch.cummax``
    over one long row is one sequential scan on the card, 15x slower on
    an H100 at 1.7e7 steps (``probes/gaf_chunker.py``)."""
    import torch

    is_first = torch.ones_like(read_id, dtype=torch.bool)
    is_first[1:] = read_id[1:] != read_id[:-1]
    rid = read_id.long()
    first = torch.zeros(n_reads + 1, dtype=torch.int64, device=rid.device)
    first.scatter_(
        0, torch.where(is_first, rid, n_reads),
        torch.arange(rid.shape[0], device=rid.device),
    )
    return pos_global[first[rid]]


def chunk_reads(
    seg_len: torch.Tensor,  # int32[N]
    steps: torch.Tensor,  # int32[T] read steps: uint32 handles' bits
    read_id: torch.Tensor,  # int32[T]
    read_start: torch.Tensor,  # int64[R]
    read_end: torch.Tensor,  # int64[R]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Classify every read step: (kind uint8[T], a int64[T], b int64[T]).

    kind is NONE / ALL / PARTIAL; for PARTIAL, [a, b) is the in-segment
    bp range (orientation-respecting, as in the reference). All on the
    device of ``seg_len`` (the CPU when it is a host array), with no
    host round trip. Each argument is a tensor on that device or, as the
    reference takes them, a numpy array (``steps`` uint32 handles or
    their int32 bits), converted once, here; a tensor on another device
    is refused.
    """
    import torch

    from ..device import op_tensor

    dev = seg_len.device if isinstance(seg_len, torch.Tensor) else "cpu"
    seg_len = op_tensor(seg_len, dev, torch.int32)
    steps = op_tensor(steps, dev, torch.int32)
    read_id = op_tensor(read_id, dev, torch.int32)
    read_start = op_tensor(read_start, dev, torch.int64)
    read_end = op_tensor(read_end, dev, torch.int64)
    # Handles are uint32 bits in int32: `>>` is arithmetic, so mask.
    seg = (steps >> 1) & 0x7FFFFFFF
    lens = seg_len[seg.long()].long()
    pos_global = torch.cumsum(lens, 0) - lens  # exclusive, over all reads

    # Per-read positions: subtract the read's base offset.
    rid = read_id.long()
    pos = pos_global - _read_base(pos_global, read_id, read_start.shape[0])
    nxt = pos + lens

    start = read_start[rid]
    end = read_end[rid]

    started = nxt > start  # this step reaches past `start`
    prev_started = pos > start  # an earlier step already did
    ended = nxt > end
    prev_ended = pos > end

    first_start = started & ~prev_started
    kind = torch.where(
        first_start | (prev_started & ~prev_ended & ended),
        KIND_PARTIAL,
        torch.where(prev_started & ~prev_ended, KIND_ALL, KIND_NONE),
    ).to(torch.uint8)

    a = torch.where(first_start, start - pos, 0)
    b = torch.where(ended, end - pos, lens)
    return kind, a, b


def chunk_events(
    g: GraphArrays, dg: TorchGraph, reads: GafReads
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(read_id, kind, a, b) arrays for all read steps."""
    t = reads.steps.shape[0]
    read_id = np.repeat(
        np.arange(reads.num_reads, dtype=np.int32),
        np.diff(reads.read_bounds),
    )
    if t == 0:
        return read_id, np.zeros(0, np.uint8), np.zeros(0), np.zeros(0)
    import torch

    dev = dg.device
    kind, a, b = chunk_reads(
        dg.seg_len,
        torch.from_numpy(reads.steps.view(np.int32)).to(dev),
        torch.from_numpy(read_id).to(dev),
        torch.from_numpy(reads.start).to(dev),
        torch.from_numpy(reads.end).to(dev),
    )
    return read_id, kind.cpu().numpy(), a.cpu().numpy(), b.cpu().numpy()


# ---------------------------------------------------------------------------
# Text renderings (reference: gaf.rs ChunkEvent::print / print_seq,
# cli/cmds.rs gaf_lookup)
# ---------------------------------------------------------------------------


def run_gaf_lookup(
    g: GraphArrays,
    dg: TorchGraph,
    reads: GafReads,
    seqs: bool = False,
    bench: bool = False,
) -> str:
    read_id, kind, a, b = chunk_events(g, dg, reads)
    if bench:
        return f"{kind.shape[0]}\n"

    names = g.seg_name
    seg_ids = (reads.steps >> 1).astype(np.int64)
    revs = (reads.steps & 1).astype(bool)
    lens = g.seg_len[seg_ids]

    out: List[str] = []
    for r in range(reads.num_reads):
        lo, hi = reads.read_bounds[r], reads.read_bounds[r + 1]
        if seqs:
            out.append(reads.read_name(r).decode() + "\t")
            for i in range(lo, hi):
                if kind[i] == KIND_NONE:
                    continue
                seq = g.seg_sequence(int(seg_ids[i]))
                if revs[i]:
                    seq = _revcomp(seq)
                if kind[i] == KIND_PARTIAL:
                    seq = seq[int(a[i]) : int(b[i])]
                out.append(seq.decode())
            out.append("\n")
        else:
            out.append(reads.read_name(r).decode() + "\n")
            for i in range(lo, hi):
                idx = i - lo
                ori = "-" if revs[i] else "+"
                if kind[i] == KIND_NONE:
                    out.append(f"{idx}: (skipped)")
                elif kind[i] == KIND_ALL:
                    out.append(
                        f"{idx}: {names[seg_ids[i]]}{ori}, {lens[i]}bp"
                    )
                else:
                    out.append(
                        f"{idx}: {names[seg_ids[i]]}{ori}, "
                        f"{int(a[i])}-{int(b[i])}bp"
                    )
    return "".join(out)


def run_gaf_lookup_stream(
    g: GraphArrays,
    dg: TorchGraph,
    filename: str,
    seqs: bool = False,
    bench: bool = False,
    window_bytes: int = DEFAULT_GAF_WINDOW,
):
    """Streaming GAF lookup: yields output text per byte window, so a
    multi-GB read set processes under an O(window) memory cap (the
    in-memory :func:`run_gaf_lookup` is the one-window special case)."""
    names = g.seg_id_by_name()
    total = 0
    for reads in iter_gaf_windows(filename, names, window_bytes):
        if bench:
            _, kind, _, _ = chunk_events(g, dg, reads)
            total += int(kind.shape[0])
        else:
            yield run_gaf_lookup(g, dg, reads, seqs=seqs)
    if bench:
        yield f"{total}\n"


_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def _revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]


# ---------------------------------------------------------------------------
# Pangenotype matrix (reference: ops/pangenotype.rs)
# ---------------------------------------------------------------------------


def _pangenotype_row(
    path: str, names: NameIndex, n_segs: int, window_bytes: int
) -> np.ndarray:
    row = np.zeros(n_segs, dtype=bool)
    # Within one worker the windows stream sequentially (workers=1):
    # the outer per-file pool owns the parallelism.
    for reads in iter_gaf_windows(path, names, window_bytes, workers=1):
        row[(reads.steps >> 1).astype(np.int64)] = True
    return row


def _pg_worker(args) -> np.ndarray:
    path, n_segs, window_bytes = args
    return _pangenotype_row(
        path, _WORKER_NAMES["names"], n_segs, window_bytes
    )


def pangenotype_matrix(
    g: GraphArrays,
    gaf_files: List[str],
    window_bytes: int = DEFAULT_GAF_WINDOW,
    workers: int | None = None,
) -> np.ndarray:
    """bool[samples, N]: does each read set touch each segment?

    Streams each GAF in windows — memory is O(window + matrix), not
    O(read set). Multiple files parse in parallel worker processes
    (reference analogue: the rayon-parallel read loop,
    cli/cmds.rs:339-347), each returning only its N-byte row — the
    cheapest possible merge."""
    auto = workers is None
    if auto:
        workers = default_gaf_workers()
    out = np.zeros((len(gaf_files), g.num_segments), dtype=bool)
    names = g.seg_id_by_name()
    import os

    total = sum(os.path.getsize(p) for p in gaf_files)
    big = total > (64 << 20) or not auto
    if workers > 1 and len(gaf_files) > 1 and big:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        ctx = mp.get_context("spawn")
        with ProcessPoolExecutor(
            min(workers, len(gaf_files)),
            mp_context=ctx,
            initializer=_gaf_worker_init,
            initargs=(names,),
        ) as ex:
            rows = ex.map(
                _pg_worker,
                [(p, g.num_segments, window_bytes) for p in gaf_files],
            )
            for i, row in enumerate(rows):
                out[i] = row
        return out
    for i, path in enumerate(gaf_files):
        out[i] = _pangenotype_row(path, names, g.num_segments, window_bytes)
    return out


def run_pangenotype(g: GraphArrays, gaf_files: List[str]) -> str:
    matrix = pangenotype_matrix(g, gaf_files)
    digits = matrix.astype(np.uint8) + ord("0")
    newlines = np.full((digits.shape[0], 1), ord("\n"), np.uint8)
    return np.concatenate([digits, newlines], axis=1).tobytes().decode(
        "ascii"
    )
