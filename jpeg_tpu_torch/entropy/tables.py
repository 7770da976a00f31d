"""Canonical Huffman tables and flat decode LUTs.

Parity: reference ``src/jpeg/huffman.rs:13-98`` (``HuffmanCode``,
``HuffmanTable::from_size_data_tables``, ``make_code_table`` — JPEG Annex C
Fig. C.2). The reference stores a sorted code list and does an O(table) linear
scan per decoded symbol (``src/jpeg/huffman.rs:211-227``). This design
instead builds a flat 2^16-entry lookup table: peek 16 bits -> (value, code
length) in O(1). The same structure feeds the NumPy oracle decoders
(``entropy/oracle.py``, ``progressive.py``), the C++ runtime and, cut to an
11-bit table plus a canonical walk, the CUDA lane decoder.

Copy of ``jpeg_tpu/entropy/tables.py``, held to it by the port's tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LUT_BITS = 16
LUT_SIZE = 1 << LUT_BITS


def make_code_table(code_lengths: np.ndarray) -> np.ndarray:
    """JPEG Annex C Figure C.2: assign canonical codes to sorted code lengths.

    ``code_lengths`` is the expanded per-code length list (ascending). Returns
    uint16 code values. Mirrors reference ``src/jpeg/huffman.rs:80-98``.
    """
    codes = np.zeros(len(code_lengths), dtype=np.uint16)
    code = 0
    if len(code_lengths) == 0:
        return codes
    current_size = int(code_lengths[0])
    for i, size in enumerate(code_lengths):
        size = int(size)
        while size > current_size:
            code <<= 1
            current_size += 1
        if code > 0xFFFF:
            # Over-subscribed BITS list (violates Kraft inequality) — only
            # reachable from a malformed DHT segment.
            raise ValueError("invalid Huffman table: code space exhausted")
        codes[i] = code
        if current_size > 16 or code == 0xFFFF:
            codes = codes[: i + 1]
            break
        code += 1
    return codes


@dataclasses.dataclass
class HuffmanTable:
    """One decode table: canonical code list + flat 16-bit LUT.

    ``bits``  — 16 counts: bits[i] codes of length i+1 (DHT BITS list).
    ``values``— symbol for code j (DHT HUFFVAL list).
    ``lengths``/``codes`` — expanded per-code length and canonical code.
    ``lut_value``/``lut_length`` — LUT_SIZE u8 arrays: peek 16 bits -> symbol /
    code length; length 0 marks an invalid prefix.
    """

    bits: np.ndarray  # [16] u8
    values: np.ndarray  # [n] u8
    lengths: np.ndarray  # [n] u8
    codes: np.ndarray  # [n] u16
    lut_value: np.ndarray  # [65536] u8
    lut_length: np.ndarray  # [65536] u8

    @staticmethod
    def from_bits_values(bits, values) -> "HuffmanTable":
        """Build from DHT (BITS, HUFFVAL).

        Parity: reference ``HuffmanTable::from_size_data_tables``
        (``src/jpeg/huffman.rs:37-58``), plus the LUT the reference lacks.
        """
        bits = np.asarray(bits, dtype=np.uint8)
        values = np.asarray(values, dtype=np.uint8)
        if bits.shape != (16,):
            raise ValueError(f"DHT BITS list must have 16 entries, got {bits.shape}")
        lengths = np.repeat(np.arange(1, 17, dtype=np.uint8), bits)
        if len(lengths) != len(values):
            # Truncated/corrupt DHT segment (counts disagree with HUFFVAL).
            raise ValueError(
                f"DHT mismatch: {len(lengths)} codes declared, "
                f"{len(values)} values present"
            )
        codes = make_code_table(lengths)
        n = len(codes)
        lengths = lengths[:n]
        values = values[:n]

        lut_value = np.zeros(LUT_SIZE, dtype=np.uint8)
        lut_length = np.zeros(LUT_SIZE, dtype=np.uint8)
        for code, length, value in zip(codes, lengths, values):
            length = int(length)
            lo = int(code) << (LUT_BITS - length)
            hi = lo + (1 << (LUT_BITS - length))
            lut_value[lo:hi] = value
            lut_length[lo:hi] = length
        return HuffmanTable(
            bits=bits,
            values=values,
            lengths=lengths,
            codes=codes,
            lut_value=lut_value,
            lut_length=lut_length,
        )

    def decode16(self, peek: int) -> tuple[int, int]:
        """Decode the symbol in the top bits of a 16-bit peek. -> (value, len).

        len == 0 means invalid prefix (reference panics in that case,
        ``src/jpeg/huffman.rs:151-156``).
        """
        return int(self.lut_value[peek]), int(self.lut_length[peek])


def empty_table() -> HuffmanTable:
    """All-invalid table used to fill unused DC/AC slots (ids 0..3)."""
    return HuffmanTable(
        bits=np.zeros(16, dtype=np.uint8),
        values=np.zeros(0, dtype=np.uint8),
        lengths=np.zeros(0, dtype=np.uint8),
        codes=np.zeros(0, dtype=np.uint16),
        lut_value=np.zeros(LUT_SIZE, dtype=np.uint8),
        lut_length=np.zeros(LUT_SIZE, dtype=np.uint8),
    )


# Table F.2 "receive and extend": raw -> signed coefficient.
def value_correction(val: int, nbits: int) -> int:
    """Sign-extend an ``nbits``-bit magnitude per JPEG Table F.2.

    Parity: reference ``src/jpeg/huffman.rs:256-268``.
    """
    if nbits == 0:
        return 0
    base = 1 << (nbits - 1)
    if val < base:
        return val - 2 * base + 1
    return val


def value_correction_np(vals: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Vectorized Table F.2 sign extension (int32)."""
    vals = vals.astype(np.int32)
    nbits = nbits.astype(np.int32)
    base = np.where(nbits > 0, 1 << np.maximum(nbits - 1, 0), 0)
    out = np.where((nbits > 0) & (vals < base), vals - 2 * base + 1, vals)
    return np.where(nbits > 0, out, 0)
