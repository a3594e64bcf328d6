"""The plain reference: subset depth straight from the arena's step
list, in numpy, imports nothing of the program.

For a path mask, odgi's ``depth -d -s`` gives each segment two numbers:
its depth, the steps of the selected paths that visit it, and its
unique depth, the selected paths that visit it at least once. The
reference counts each path's visits to each segment once, at set-up of
the check (``Reference``), and answers masks from those counts. It reads
the same arena the program ingests (packed step handles and each path's
step range), never the program's index.

Where the paths times the segments are few enough (``DENSE_LIMIT``) and
every sum stays exact in float32, the counts are one (P, N) matrix from
one ``np.bincount`` of (path, segment) keys, and a block of masks is
answered by two matrix products. Otherwise they are the (path, segment)
runs (``np.unique`` a block of paths at a time), and a mask by two
``np.bincount`` over the selected paths' runs: the form a configuration
with many paths (reads injected as paths) needs, kept here because a
later configuration adds files and does not edit this one.

The control (``answers(..., clip=CONTROL_CLIP)``) is the same reference
with one guarantee of the configuration broken: a path's count on a
segment held in 4 bits, the overflow left out (what a query that dropped
the program's clip residual would answer). It has to come out as not
correct.
"""

from __future__ import annotations

import numpy as np

# Steps per block of paths while the runs are counted: bounds the
# check's host memory at about 0.5 GB of keys.
BLOCK_STEPS = 1 << 25
# Most (path, segment) counts held as one dense float32 matrix.
DENSE_LIMIT = 1 << 28
# float32 holds every integer below this exactly.
EXACT_F32 = 1 << 24
CONTROL_CLIP = 15


def _owners_and_steps(bounds: np.ndarray, first: int, last: int):
    """Path id and step index of every step of paths first..last-1."""
    lens = bounds[first:last, 1] - bounds[first:last, 0]
    owner = np.repeat(np.arange(first, last, dtype=np.int64), lens)
    idx = np.concatenate([np.arange(lo, hi) for lo, hi in bounds[first:last]])
    return owner, idx


class Reference:
    """Every path's count on every segment of an arena: ``count`` as a
    dense (P, N) float32 matrix, or ``run_path``, ``run_seg``,
    ``run_count`` (int64, ordered by path, then segment)."""

    def __init__(self, steps: np.ndarray, path_steps: np.ndarray,
                 n_segments: int):
        self.n = int(n_segments)
        bounds = path_steps.astype(np.int64)
        self.n_paths = bounds.shape[0]
        seg = (steps >> 1).astype(np.int64)
        self.count = None
        self._dense = {}
        if self.n_paths * self.n <= DENSE_LIMIT:
            owner, idx = _owners_and_steps(bounds, 0, self.n_paths)
            count = np.bincount(owner * self.n + seg[idx],
                                minlength=self.n_paths * self.n)
            del owner, idx
            if count.max(initial=0) * self.n_paths < EXACT_F32:
                self.count = count.reshape(self.n_paths, self.n).astype(np.float32)
                return
        paths, segs, counts = [], [], []
        first = 0
        while first < self.n_paths:
            last = first
            total = 0
            while last < self.n_paths and (last == first or total
                                           + bounds[last, 1] - bounds[last, 0]
                                           <= BLOCK_STEPS):
                total += bounds[last, 1] - bounds[last, 0]
                last += 1
            owner, idx = _owners_and_steps(bounds, first, last)
            u, c = np.unique(owner * self.n + seg[idx], return_counts=True)
            paths.append(u // self.n)
            segs.append(u % self.n)
            counts.append(c)
            first = last
        self.run_path = np.concatenate(paths)
        self.run_seg = np.concatenate(segs)
        self.run_count = np.concatenate(counts).astype(np.int64)

    def answers(self, masks: np.ndarray, clip: int | None = None):
        """(depth, uniq) int64[Q, N] for (Q, P) bool masks; with
        ``clip``, each path's count on a segment is held at most
        ``clip`` (the control)."""
        masks = np.atleast_2d(np.asarray(masks, bool))
        if self.count is not None:
            m = masks.astype(np.float32)
            depth = np.rint(m @ self._matrix(clip)).astype(np.int64)
            uniq = np.rint(m @ self._matrix(1)).astype(np.int64)
            return depth, uniq
        out = [self._answer_runs(m, clip) for m in masks]
        return np.stack([d for d, _ in out]), np.stack([u for _, u in out])

    def _matrix(self, clip: int | None) -> np.ndarray:
        """The dense counts, each held at most ``clip`` (1: a visit or
        none), made once."""
        if clip is None:
            return self.count
        if clip not in self._dense:
            self._dense[clip] = np.minimum(self.count, np.float32(clip))
        return self._dense[clip]

    def _answer_runs(self, mask: np.ndarray, clip: int | None):
        sel = mask[self.run_path]
        segs = self.run_seg[sel]
        counts = self.run_count[sel]
        if clip is not None:
            counts = np.minimum(counts, clip)
        depth = np.bincount(segs, weights=counts, minlength=self.n)
        uniq = np.bincount(segs, minlength=self.n)
        return depth.astype(np.int64), uniq.astype(np.int64)

    def answer(self, mask: np.ndarray, clip: int | None = None):
        """(depth, uniq) int64[N] for one bool mask over the paths."""
        depth, uniq = self.answers(np.asarray(mask, bool)[None], clip)
        return depth[0], uniq[0]

    def control_answer(self, mask: np.ndarray):
        return self.answer(mask, clip=CONTROL_CLIP)


def differences(got_depth, got_uniq, want) -> dict:
    """Elements of one answer that differ from the reference's, and
    whether its shape is wrong (a wrong shape counts every element)."""
    n = want[0].shape[0]
    out = {}
    for name, got, w in (("depth", got_depth, want[0]), ("uniq", got_uniq, want[1])):
        got = np.asarray(got)
        if got.shape != (n,):
            out[name] = n
        else:
            out[name] = int(np.count_nonzero(got.astype(np.int64) != w))
    return out
