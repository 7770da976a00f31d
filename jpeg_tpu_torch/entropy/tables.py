"""Canonical Huffman tables and flat decode LUTs.

Parity: reference ``src/jpeg/huffman.rs:13-98`` (``HuffmanCode``,
``HuffmanTable::from_size_data_tables``, ``make_code_table`` — JPEG Annex C
Fig. C.2). The reference stores a sorted code list and does an O(table) linear
scan per decoded symbol (``src/jpeg/huffman.rs:211-227``). This design
instead builds a flat 2^16-entry lookup table: peek 16 bits -> (value, code
length) in O(1). The same structure feeds the NumPy oracle decoders
(``entropy/oracle.py``, ``progressive.py``), the C++ runtime and, cut to an
11-bit table plus a canonical walk, the CUDA lane decoder.

Copy of ``jpeg_tpu/entropy/tables.py``, held to it by the port's tests. The
port's own addition: tables are shared. :meth:`HuffmanTable.from_bits_values`
builds a table once per DHT content (BITS and HUFFVAL bytes) and keeps it in
:data:`TABLES`, a bounded process-wide cache; every later request for the
same bytes gets its own :class:`HuffmanTable` over the same read-only
arrays. A corpus whose frames share their tables (one encoder's standard
tables) then parses without rebuilding a 64K-entry LUT per table per frame.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

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
        """Build from DHT (BITS, HUFFVAL), shared: a table of its own whose
        arrays are read-only and kept for every request of the same bytes
        (at most :data:`TABLE_CACHE_SIZE` = 64 tables, 8.1 MiB; see
        :func:`shared_table`). :meth:`build` makes an unshared one."""
        return shared_table(bits, values)[0]

    @staticmethod
    def build(bits, values) -> "HuffmanTable":
        """Build from DHT (BITS, HUFFVAL), unshared: fresh, writable arrays
        (``bits`` and ``values`` may be views of the arguments). What
        :func:`shared_table` runs on a miss.

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
    """All-invalid table used to fill unused DC/AC slots (ids 0..3): the
    table of 16 zero counts and no values, shared like
    :func:`shared_table`'s (its arrays are read-only and built once a
    process)."""
    return _EMPTY.table()


class SharedCache:
    """A bounded, thread-safe LRU map from a key of bytes to what is derived
    from them. :meth:`get` builds a missing value outside the lock, so two
    threads may build the same one at once; the first to finish is kept and
    both get it. A build that raises leaves no entry. Past ``size`` entries
    the least recently used goes."""

    def __init__(self, size: int):
        self.size = size
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key, build):
        """-> (value, reused): the kept value of ``key``, built by
        ``build()`` on a miss; ``reused`` is whether it was there."""
        with self._lock:
            value = self._entries.get(key)
            if value is not None:
                self._entries.move_to_end(key)
                return value, True
        value = build()
        with self._lock:
            value = self._entries.setdefault(key, value)
            self._entries.move_to_end(key)
            while len(self._entries) > self.size:
                self._entries.popitem(last=False)
        return value, False

    def peek(self, key):
        """The kept value of ``key``, or None; its place in the LRU order
        is left as it is."""
        with self._lock:
            return self._entries.get(key)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


def frozen(a: np.ndarray) -> np.ndarray:
    """Make ``a`` read-only and return a view of it, which no holder can
    make writable again."""
    a.setflags(write=False)
    return a.view()


class _Shared:
    """One kept table: its DHT content key and a table of read-only arrays
    (copies, so that nothing kept holds the stream the DHT came from)."""

    __slots__ = ("key", "proto")

    def __init__(self, key, t: HuffmanTable):
        self.key = key
        self.proto = HuffmanTable(**{
            f.name: frozen(np.array(getattr(t, f.name)))
            for f in dataclasses.fields(HuffmanTable)})

    def table(self) -> HuffmanTable:
        """A table of its own over the shared arrays (:func:`table_key`
        finds its key)."""
        p = self.proto
        t = HuffmanTable(p.bits, p.values, p.lengths, p.codes, p.lut_value,
                         p.lut_length)
        t._shared = self
        return t


# 64 tables of at most 128.8 KiB each (two LUT_SIZE u8 LUTs, 16 counts,
# <= 256 values and lengths, <= 256 u16 codes): 8.1 MiB at most.
TABLE_CACHE_SIZE = 64
TABLES = SharedCache(TABLE_CACHE_SIZE)
_EMPTY = _Shared((bytes(16), b""), HuffmanTable.build(np.zeros(16, np.uint8),
                                                      np.zeros(0, np.uint8)))


def shared_table(bits, values) -> tuple[HuffmanTable, bool]:
    """The table of DHT (``bits``, ``values``) -> (table, reused).

    Built by :meth:`HuffmanTable.build` at the first request for these
    exact bytes (a DHT that fails its checks raises as there, and is not
    kept), then kept in :data:`TABLES`: at most :data:`TABLE_CACHE_SIZE`
    tables, least recently used dropped, 8.1 MiB at most. Each call
    returns a new :class:`HuffmanTable` whose arrays are the kept,
    read-only ones, so reassigning an attribute of one caller's table
    reaches no other; ``reused`` is whether the bytes were already kept.
    Thread-safe.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    values = np.asarray(values, dtype=np.uint8)
    if bits.shape != (16,) or values.ndim != 1:
        return HuffmanTable.build(bits, values), False
    key = (bits.tobytes(), values.tobytes())
    entry, reused = TABLES.get(
        key, lambda: _Shared(key, HuffmanTable.build(bits, values)))
    return entry.table(), reused


def table_key(t: HuffmanTable):
    """The DHT content key of a table that :func:`shared_table` or
    :func:`empty_table` handed out, while the table is still kept and its
    LUTs are still the kept arrays; None for any other table (a copy, one
    whose LUTs were reassigned, one dropped from the cache)."""
    shared = getattr(t, "_shared", None)
    if shared is None:
        return None
    if shared is not _EMPTY and TABLES.peek(shared.key) is not shared:
        return None
    p = shared.proto
    if t.lut_value is not p.lut_value or t.lut_length is not p.lut_length:
        return None
    return shared.key


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
