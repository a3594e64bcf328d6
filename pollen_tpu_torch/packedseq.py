"""Packed nucleotide sequences: two bases per byte, nibble-encoded.

The port's own copy of the JAX package's pollen_tpu/packedseq.py.
Reference semantics and on-disk format: flatgfa/src/packedseq.rs —
codes A=0, C=1, T=2, G=3; even positions in the low nibble, odd in the
high; a 25-byte TOC (magic 0x12, data len/capacity, final-nibble flag).
Packing/unpacking is vectorized NumPy, not per-base loops.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAGIC = 0x12

_CODE = np.full(256, 255, dtype=np.uint8)
for i, base in enumerate(b"ACTG"):
    _CODE[base] = i
_BASE = np.frombuffer(b"ACTG", dtype=np.uint8)

TOC_DTYPE = np.dtype(
    [
        ("magic", "<u8"),
        ("len", "<u8"),
        ("capacity", "<u8"),
        ("high_nibble_end", "u1"),
    ]
)


class PackedSeqError(ValueError):
    pass


@dataclasses.dataclass
class PackedSeq:
    """A nibble-packed nucleotide sequence."""

    data: np.ndarray  # uint8[B]
    high_nibble_end: bool

    def __len__(self) -> int:
        if self.data.shape[0] == 0:
            return 0
        return self.data.shape[0] * 2 - (0 if self.high_nibble_end else 1)

    @classmethod
    def from_ascii(cls, seq: bytes) -> "PackedSeq":
        arr = np.frombuffer(seq, dtype=np.uint8)
        codes = _CODE[arr]
        if (codes == 255).any():
            bad = chr(arr[codes == 255][0])
            raise PackedSeqError(f"not a nucleotide: {bad!r}")
        odd = codes.shape[0] % 2 == 1
        if odd:
            codes = np.concatenate([codes, np.zeros(1, np.uint8)])
        pairs = codes.reshape(-1, 2)
        data = pairs[:, 0] | (pairs[:, 1] << np.uint8(4))
        return cls(data=data, high_nibble_end=not odd)

    def to_ascii(self) -> bytes:
        lo = self.data & np.uint8(0x0F)
        hi = self.data >> np.uint8(4)
        codes = np.stack([lo, hi], axis=1).reshape(-1)[: len(self)]
        return _BASE[codes].tobytes()

    def __getitem__(self, index: int) -> str:
        byte = int(self.data[index // 2])
        code = (byte >> 4) if index % 2 else (byte & 0x0F)
        return chr(_BASE[code])

    # -- file format ------------------------------------------------------

    def to_file_bytes(self) -> bytes:
        toc = np.zeros((), dtype=TOC_DTYPE)
        toc["magic"] = MAGIC
        toc["len"] = self.data.shape[0]
        toc["capacity"] = self.data.shape[0]
        toc["high_nibble_end"] = 1 if self.high_nibble_end else 0
        return toc.tobytes() + self.data.tobytes()

    def save(self, filename: str) -> None:
        with open(filename, "wb") as f:
            f.write(self.to_file_bytes())

    @classmethod
    def from_file_bytes(cls, data: bytes) -> "PackedSeq":
        if len(data) < TOC_DTYPE.itemsize:
            raise PackedSeqError("file too small for packed-seq TOC")
        toc = np.frombuffer(data, dtype=TOC_DTYPE, count=1)[0]
        if toc["magic"] != MAGIC:
            raise PackedSeqError("bad magic: not a packed-seq file")
        n = int(toc["len"])
        raw = np.frombuffer(
            data, dtype=np.uint8, count=n, offset=TOC_DTYPE.itemsize
        )
        return cls(data=raw, high_nibble_end=bool(toc["high_nibble_end"]))

    @classmethod
    def load(cls, filename: str) -> "PackedSeq":
        with open(filename, "rb") as f:
            return cls.from_file_bytes(f.read())


def seq_export(input_file: str, output_file: str) -> None:
    """Pack an ASCII nucleotide text file (whitespace ignored)."""
    with open(input_file, "rb") as f:
        raw = f.read()
    cleaned = bytes(c for c in raw if c not in b" \t\r\n")
    PackedSeq.from_ascii(cleaned).save(output_file)


def seq_import(filename: str) -> bytes:
    """Unpack a packed-seq file back to ASCII."""
    return PackedSeq.load(filename).to_ascii()
