"""Pair-symbol precomputed-value tables of the v3 device entropy tier.

Copy of ``jpeg_tpu/entropy/device_pair.py`` (host NumPy), held to it array
for array by the port's tests. In the JAX package these tables feed the v3
XLA loop (``device_decode2.decode_coefficients_device3``): one [65536]
gather resolves up to two whole symbols, magnitudes and sign extension
precomputed from the 16-bit peek. In the port the v3 name runs K3, which
derives its own tables; :func:`pair_luts` is what its ``luts`` argument is
checked against (``entropy/device_decode2.py``).

The DC table pairs the DC delta with the first AC symbol of the block;
codes whose magnitude spills past the peek take a ``slow`` entry carrying
(len, size); invalid prefixes an ``invalid`` mode (the lane error flag,
``src/jpeg/huffman.rs:151-156``).

Entry layout (i32 A = row[0], i32 B = row[1]):

  A: mode(2) | f1(6) | adv1(8) | w1(1) | v1(13)
     mode: 0=single 1=pair 2=slow 3=invalid
     f1:   total consumed bits (single/pair) or code length (slow)
     adv1: coefficient advance of symbol 1 (run+1; 64 for EOB, 16 ZRL)
     w1:   symbol 1 writes a coefficient
     v1:   sign-extended value, two's complement in 13 bits
           (slow: low 5 bits = magnitude bit count)
  B: adv2(8) | w2(1) | v2(13)   (pair mode only, else 0)

Reference behavior contract: ``src/jpeg/huffman.rs:109-268``.
"""

from __future__ import annotations

import numpy as np

from jpeg_tpu_torch.entropy.tables import HuffmanTable
from jpeg_tpu_torch.io.container import DecodePlan

MODE_SINGLE, MODE_PAIR, MODE_SLOW, MODE_INVALID = 0, 1, 2, 3


def _sym_fields(lut_value, is_dc):
    """(adv, w, magbits) per 16-bit peek for one table's symbol."""
    sym = lut_value.astype(np.int32)
    if is_dc:
        size = sym
        adv = np.ones_like(sym)
        w = np.ones_like(sym, bool)
        return adv, w, size
    is_eob = sym == 0x00
    is_zrl = sym == 0xF0
    run = (sym >> 4) & 0xF
    size = sym & 0xF
    adv = np.where(is_eob, 64, np.where(is_zrl, 16, run + 1))
    w = ~(is_eob | is_zrl)
    magbits = np.where(is_eob | is_zrl, 0, size)
    return adv, w, magbits


def _extract_val(i, off, nbits):
    """Sign-extended magnitude bits [off, off+nbits) of the 16-bit peek
    value ``i`` (JPEG Table F.2), vectorized. Requires off+nbits <= 16."""
    raw = (i >> np.maximum(16 - off - nbits, 0)) & ((1 << nbits) - 1)
    half = np.where(nbits > 0, 1 << np.maximum(nbits - 1, 0), 1)
    return np.where((nbits > 0) & (raw < half),
                    raw - 2 * half + 1, raw).astype(np.int64)


def build_pair_table(first: HuffmanTable, follow: HuffmanTable,
                     first_is_dc: bool) -> np.ndarray:
    """[65536, 2] i32 pair-entry table: symbol 1 from ``first``,
    optional symbol 2 from ``follow`` (the block's AC table)."""
    i = np.arange(65536, dtype=np.int64)
    len1 = first.lut_length.astype(np.int64)
    adv1, w1, mag1 = _sym_fields(first.lut_value, first_is_dc)
    c1 = len1 + mag1
    # Spec-legal tables have len <= 16 and size <= 15 (c1 <= 31, within
    # the register's single-shift consume limit); a corrupt table that
    # exceeds it maps to the invalid mode (reference panic semantics).
    invalid = (len1 == 0) | (c1 > 31)
    # v1 is a 13-bit two's-complement field: magnitudes of >= 13 bits
    # (legal in 12-bit streams — DC size up to 15, AC up to 14) would
    # wrap mod 8192. Route them through the slow path, whose in-kernel
    # extraction handles the full range.
    slow = (~invalid) & ((c1 > 16) | (mag1 >= 13))
    eob1 = (not first_is_dc) & (first.lut_value == 0x00) & ~invalid

    val1 = _extract_val(i, np.minimum(len1, 16), np.where(slow, 0, mag1))

    # Symbol 2: resolvable iff the full code+magnitude fits the peek.
    # Garbage low bits of i2 cannot corrupt the lookup when len2 fits:
    # codes are prefix-free, so every completion of a <= (16-c1)-bit
    # code maps to it; otherwise len2 reads as > 16-c1 or 0 and the
    # pair is rejected either way.
    i2 = (i << np.minimum(c1, 16)) & 0xFFFF
    len2 = follow.lut_length.astype(np.int64)[i2]
    adv2f, w2f, mag2f = _sym_fields(follow.lut_value[i2], False)
    c2 = len2 + mag2f
    pair = ((~invalid) & (~slow) & (~eob1) & (len2 > 0)
            & (c1 + c2 <= 16) & (mag2f < 13))
    val2 = _extract_val(i, c1 + np.minimum(len2, 16),
                        np.where(pair, mag2f, 0))

    mode = np.where(
        invalid, MODE_INVALID,
        np.where(slow, MODE_SLOW,
                 np.where(pair, MODE_PAIR, MODE_SINGLE)))
    # f1 = total consumed bits: sym1 only (single), both symbols (pair),
    # or the code length alone (slow — magnitude bits added in-kernel).
    f1 = np.where(slow, len1, np.where(pair, c1 + c2, c1))
    v1 = np.where(slow, mag1, val1 & 0x1FFF)
    a = (mode | (f1 << 2) | (adv1 << 8) | (w1.astype(np.int64) << 16)
         | (v1 << 17))
    # B also carries sym1's own bit count (c1): when sym1 already fills
    # the block (run to position 63 without EOB), the runtime must NOT
    # consume sym2's bits — they belong to the next block's DC code.
    b = np.where(pair,
                 adv2f | (w2f.astype(np.int64) << 8)
                 | ((val2 & 0x1FFF) << 9) | (c1 << 22), 0)
    return np.stack([a, b], axis=-1).astype(np.int32)


def pair_luts(plan: DecodePlan):
    """Stacked pair tables for the plan's slot bindings:
    ([2*n_pairs, 2, 65536] i32, slot -> pair-index tuple). Row 2p is the
    DC-start table of binding p, row 2p+1 its AC table; the second axis
    separates the A/B entry words so the kernel gathers each from a
    static slice (a [65536, 2] row gather lowers badly on this stack)."""
    slots = plan.component_block_slots()
    bindings = []
    slot_pair = []
    for ci, _sub in slots:
        comp = plan.components[ci]
        key = (comp.dc_id, comp.ac_id)
        if key not in bindings:
            bindings.append(key)
        slot_pair.append(bindings.index(key))
    rows = []
    for dc_id, ac_id in bindings:
        dc_t = plan.dc_tables[dc_id]
        ac_t = plan.ac_tables[ac_id]
        rows.append(build_pair_table(dc_t, ac_t, True))
        rows.append(build_pair_table(ac_t, ac_t, False))
    return np.moveaxis(np.stack(rows), 2, 1).copy(), tuple(slot_pair)
