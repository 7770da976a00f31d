"""Sequential scalar entropy decoder — the in-repo correctness oracle.

Parity: reference ``HuffmanDecoder`` (``src/jpeg/huffman.rs:109-268``) and the
MCU interleave loop (``src/jpeg/decoder.rs:195-215``), reproduced exactly:
32-bit sliding window, MSB-first reads, Table F.2 sign extension, EOB/ZRL
handling, 0xAA tail padding past end-of-stream, per-component DC prediction.
Extended beyond the reference with restart-segment support (DC predictors and
bit alignment reset per segment) and spec-correct MCU geometry.

Deliberately simple and slow (SURVEY.md §7 layer 2): every parallel decoder
(C++ runtime, device lane decoder) is equivalence-tested against this.

Copy of ``jpeg_tpu/entropy/oracle.py``; ``engine="oracle"`` of the port's
decoder runs it, and the port's tests hold it to the JAX package's and to
the C++ runtime bit for bit.
"""

from __future__ import annotations

import numpy as np

from jpeg_tpu_torch.entropy.tables import HuffmanTable, value_correction
from jpeg_tpu_torch.io.container import DecodePlan


class BitReader:
    """32-bit sliding-window MSB-first bit reader.

    Parity: reference ``HuffmanDecoder::{new, read_n_bits,
    shift_and_fix_current}`` (``src/jpeg/huffman.rs:124-254``), including the
    0xAA fill byte once past the end of the stream.
    """

    def __init__(self, data: np.ndarray):
        self.data = data
        pad = [0xAA] * max(0, 4 - len(data))
        first4 = list(data[:4]) + pad
        self.current = (
            (int(first4[0]) << 24)
            | (int(first4[1]) << 16)
            | (int(first4[2]) << 8)
            | int(first4[3])
        )
        self.next_index = 4
        self.bits_read = 0  # bits consumed within the current byte

    def peek16(self) -> int:
        return (self.current >> 16) & 0xFFFF

    def consume(self, nbits: int) -> None:
        if nbits == 0:
            return
        self.current = (self.current << nbits) & 0xFFFFFFFF
        self.bits_read += nbits
        while self.bits_read >= 8:
            self.bits_read -= 8
            if self.next_index >= len(self.data):
                nxt = 0xAA
            else:
                nxt = int(self.data[self.next_index])
            self.current |= nxt << self.bits_read
            self.next_index += 1

    def read_bits(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        assert nbits <= 16
        val = self.peek16() >> (16 - nbits)
        self.consume(nbits)
        return val

    @property
    def bit_position(self) -> int:
        """Absolute bit offset of the read cursor from stream start."""
        return (self.next_index - 4) * 8 + self.bits_read


def decode_symbol(reader: BitReader, table: HuffmanTable) -> int:
    """Decode one Huffman symbol via the flat LUT.

    Equivalent to the reference's linear scan ``next_code``
    (``src/jpeg/huffman.rs:211-227``) but O(1).
    """
    value, length = table.decode16(reader.peek16())
    if length == 0:
        raise ValueError(
            f"invalid Huffman prefix {reader.peek16():016b} "
            f"(reference panics here, src/jpeg/huffman.rs:151-156)"
        )
    reader.consume(length)
    return value


def next_block(reader: BitReader, ac: HuffmanTable, dc: HuffmanTable) -> np.ndarray:
    """Decode one 64-coefficient block (zigzag order, DC as raw delta).

    Parity: reference ``HuffmanDecoder::next_block``
    (``src/jpeg/huffman.rs:146-195``): DC size+amplitude, AC run/size codes,
    EOB (0x00) zero-fill, ZRL (0xF0) 16 zeros capped at block end, run zeros
    capped at 63.
    """
    block = np.zeros(64, dtype=np.int32)
    nbits = decode_symbol(reader, dc)
    block[0] = value_correction(reader.read_bits(nbits), nbits)
    k = 1
    while k < 64:
        sym = decode_symbol(reader, ac)
        if sym == 0x00:  # EOB
            break
        if sym == 0xF0:  # ZRL: 16 zeros (capped)
            k += min(16, 64 - k)
            continue
        run = (sym & 0xF0) >> 4
        size = sym & 0x0F
        val = value_correction(reader.read_bits(size), size)
        k += min(run, 64 - k - 1)
        block[k] = val
        k += 1
    return block


def decode_coefficients(plan: DecodePlan) -> np.ndarray:
    """Entropy-decode the full scan -> [total_blocks, 64] int32 (zigzag order,
    DC prediction applied, blocks in MCU stream order).

    Parity: reference decode() step 1 (``src/jpeg/decoder.rs:195-215``) with
    restart-segment support: each segment restarts byte-aligned with DC
    predictors reset (JPEG F.2.1.3.1).
    """
    slots = plan.component_block_slots()
    out = np.zeros((plan.total_blocks, 64), dtype=np.int32)
    bi = 0
    for seg in plan.segments:
        reader = BitReader(plan.scan_data[seg.byte_start : seg.byte_end])
        prev_dc = np.zeros(len(plan.components), dtype=np.int32)
        for _ in range(seg.mcu_count):
            for ci, _sub in slots:
                comp = plan.components[ci]
                block = next_block(
                    reader, plan.ac_tables[comp.ac_id], plan.dc_tables[comp.dc_id]
                )
                block[0] += prev_dc[ci]
                prev_dc[ci] = block[0]
                out[bi] = block
                bi += 1
    # Truncated streams can carry fewer restart segments than the frame
    # geometry implies; like libjpeg's "premature end of data" recovery (and
    # the native engine), leave the missing tail blocks zero.
    return out


def decode_coefficients_with_offsets(plan: DecodePlan):
    """Like :func:`decode_coefficients` but also records the bit offset of
    every block start (used to validate the device decoder's cursor math)."""
    slots = plan.component_block_slots()
    out = np.zeros((plan.total_blocks, 64), dtype=np.int32)
    offsets = np.zeros(plan.total_blocks, dtype=np.int64)
    bi = 0
    for seg in plan.segments:
        reader = BitReader(plan.scan_data[seg.byte_start : seg.byte_end])
        prev_dc = np.zeros(len(plan.components), dtype=np.int32)
        for _ in range(seg.mcu_count):
            for ci, _sub in slots:
                comp = plan.components[ci]
                offsets[bi] = reader.bit_position
                block = next_block(
                    reader, plan.ac_tables[comp.ac_id], plan.dc_tables[comp.dc_id]
                )
                block[0] += prev_dc[ci]
                prev_dc[ci] = block[0]
                out[bi] = block
                bi += 1
    return out, offsets
