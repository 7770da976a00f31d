"""Optimized Huffman table construction (JPEG Annex K.2).

The encoder-side counterpart of the decode LUTs: given symbol frequencies
from a first statistics pass, build length-limited (<=16 bit) canonical
Huffman tables — the same algorithm family libjpeg uses for
``optimize_coding``. The reference has no encoder at all; this goes with
:mod:`jpeg_tpu_torch.models.encoder`'s ``optimize=True`` mode.

Copy of ``jpeg_tpu/entropy/optimize.py``, held to it by the port's tests.

Symbol statistics are collected fully vectorized (NumPy) from the quantized
zigzag blocks; see :func:`symbol_histograms`.
"""

from __future__ import annotations

import numpy as np

from jpeg_tpu_torch.entropy.tables import HuffmanTable


def build_optimal_table(freq256: np.ndarray) -> HuffmanTable:
    """Frequencies [256] -> canonical HuffmanTable (JPEG K.2 procedure).

    Follows the spec's CODE_SIZE / COUNT_BITS / ADJUST_BITS flowcharts: a
    reserved 257th pseudo-symbol guarantees no real symbol gets the all-ones
    code; chains longer than 16 bits are folded back per ADJUST_BITS.
    """
    freq = np.zeros(257, dtype=np.int64)
    freq[:256] = np.asarray(freq256, dtype=np.int64)
    freq[256] = 1  # reserved: claims the all-ones code point
    codesize = np.zeros(257, dtype=np.int64)
    others = np.full(257, -1, dtype=np.int64)

    while True:
        # v1 = least-frequency nonzero symbol (largest index on tie),
        # v2 = next least (largest index on tie), per spec.
        nz = np.flatnonzero(freq > 0)
        if len(nz) <= 1:
            break
        fmin = freq[nz].min()
        v1 = nz[freq[nz] == fmin].max()
        rest = nz[nz != v1]
        fmin2 = freq[rest].min()
        v2 = rest[freq[rest] == fmin2].max()

        freq[v1] += freq[v2]
        freq[v2] = 0
        codesize[v1] += 1
        while others[v1] != -1:
            v1 = others[v1]
            codesize[v1] += 1
        others[v1] = v2
        codesize[v2] += 1
        while others[v2] != -1:
            v2 = others[v2]
            codesize[v2] += 1

    # COUNT_BITS
    bits = np.zeros(max(33, int(codesize.max()) + 1), dtype=np.int64)
    for size in codesize[codesize > 0]:
        bits[int(size)] += 1

    # ADJUST_BITS: fold chains deeper than 16.
    i = len(bits) - 1
    while i > 16:
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
        i -= 1
    # Remove the reserved symbol's code from the longest nonzero length.
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1

    # Sort symbols by (code size, symbol value) -> HUFFVAL.
    order = []
    for size in range(1, 33):
        for sym in range(256):
            if codesize[sym] == size:
                order.append(sym)
    return HuffmanTable.from_bits_values(
        bits[1:17].astype(np.uint8), np.array(order, dtype=np.uint8)
    )


def _magnitude_arr(v: np.ndarray) -> np.ndarray:
    out = np.zeros(v.shape, dtype=np.int64)
    a = np.abs(v.astype(np.int64))
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def symbol_histograms(comp_blocks_zz: list[np.ndarray], samplings,
                      restart_interval_mcus: int, mcus_x: int, mcus_y: int):
    """Vectorized statistics pass -> (dc_freq [2,256], ac_freq [2,256]).

    Table id 0 = luma (component 0), 1 = chroma. DC symbols are magnitude
    sizes of the prediction deltas (restart-aware); AC symbols are
    run/size pairs plus ZRL and EOB, computed without any per-block Python
    loop (prev-nonzero via a row-wise cumulative max).
    """
    dc_freq = np.zeros((2, 256), dtype=np.int64)
    ac_freq = np.zeros((2, 256), dtype=np.int64)

    for ci, blocks in enumerate(comp_blocks_zz):
        tid = min(ci, 1)
        h, v = samplings[ci]
        rows, cols, _ = blocks.shape
        zz = blocks.reshape(-1, 64)

        # --- DC deltas in MCU stream order with restart resets ---
        # Build the stream order of this component's blocks.
        my, mx = np.divmod(np.arange(mcus_x * mcus_y), mcus_x)
        sub = np.arange(h * v)
        vi, hi = np.divmod(sub, h)
        by = (my[:, None] * v + vi[None, :]).reshape(-1)
        bx = (mx[:, None] * h + hi[None, :]).reshape(-1)
        stream = blocks[by, bx, 0].astype(np.int64)  # DC values, stream order
        prev = np.concatenate([[0], stream[:-1]])
        if restart_interval_mcus:
            # First block of each restart segment predicts from 0.
            kpm = h * v
            block_mcu = np.arange(len(stream)) // kpm
            seg_first = (block_mcu % restart_interval_mcus == 0) & (
                np.arange(len(stream)) % kpm == 0)
            prev[seg_first] = 0
        deltas = stream - prev
        np.add.at(dc_freq[tid], _magnitude_arr(deltas), 1)

        # --- AC run/size symbols ---
        ac = zz[:, 1:]
        nzmask = ac != 0
        col = np.broadcast_to(np.arange(63), ac.shape)
        marked = np.where(nzmask, col, -1)
        prev_nz = np.maximum.accumulate(marked, axis=1)
        prev_shifted = np.concatenate(
            [np.full((ac.shape[0], 1), -1), prev_nz[:, :-1]], axis=1)
        run = col - prev_shifted - 1
        sizes = _magnitude_arr(ac)
        sel = nzmask
        runs = run[sel]
        szs = sizes[sel]
        ac_freq[tid, 0xF0] += int((runs // 16).sum())  # ZRLs
        syms = ((runs % 16) << 4) | szs
        np.add.at(ac_freq[tid], syms, 1)
        # EOB wherever the block has trailing zeros.
        last_nz = prev_nz[:, -1]
        ac_freq[tid, 0x00] += int((last_nz < 62).sum())

    return dc_freq, ac_freq
