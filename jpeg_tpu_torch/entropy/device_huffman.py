"""K3, device entropy decode: one lane per restart segment.

Counterpart of ``jpeg_tpu/entropy/device_window.py``
(``decode_coefficients_device5_batch``) with the table preparation of
``jpeg_tpu/entropy/device_kernel.py`` (``_lut11``, ``_canon_params``,
``plan_kernel_tables``). The CUDA kernel is ``csrc/huffman_lanes.cu``;
:func:`decode_lanes_plain` is its plain PyTorch twin, decoding all lanes in
lockstep with tensor operations.

The kernel runs in two passes: a serial walk per lane that records where
each block starts and its DC predictor, then one thread per block decoding
the coefficients. They read tables built here (:func:`kernel_tables`): per
11-bit peek, the bits a symbol consumes and how far it advances the
coefficient index, with its code length and magnitude bits for pass 2
(:func:`skip_entries`), and for pass 1 the same for two AC symbols at once
where both fit in the peek (:func:`pair_table`).

Contract (bit for bit that of the TPU kernel run with a window that never
overflows): per image a ``[total_blocks, 64]`` int32 array of zigzag-order,
DC-predicted coefficients in MCU stream order, plus ``err [S]`` over all
lanes of the batch. A lane stops at its first invalid prefix (its later
blocks are zero) and is flagged; so is a lane that consumed more than 8 bits
past its segment end. Unflagged lanes match the C++ runtime and the oracle.
All images of a batch must share their slot structure and Huffman tables
(``ValueError`` otherwise, raised before anything is launched).

:func:`decode_lanes` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from jpeg_tpu_torch.utils.build import LaunchCounter, load_cuda_kernel

T11 = 2048  # primary LUT size (11-bit peek)
MAX_LANE_BYTES = 1 << 28  # the kernel's per-block start bits are int32

LAUNCHES = LaunchCounter()


class BatchMismatch(ValueError):
    """A batch K3 does not take, found before anything is launched: plans
    that differ in slot structure or Huffman tables, or a restart segment
    too long for a lane."""


def _lut11(table) -> np.ndarray:
    """[T11] i32: 11-bit peek -> len | sym << 8 for codes of length <= 11,
    else 0 (resolved by the canonical walk)."""
    ll = table.lut_length[::32].astype(np.int32)  # length at peek11 << 5
    lv = table.lut_value[::32].astype(np.int32)
    ok = (ll > 0) & (ll <= 11)
    return np.where(ok, ll | (lv << 8), 0)


def _canon_params(table) -> np.ndarray:
    """[15] i32: mincode[5], maxcode[5], valptr[5] for code lengths 12..16
    (maxcode -1 where the length has no codes), JPEG Annex F."""
    out = np.zeros(15, np.int32)
    out[5:10] = -1
    lengths = table.lengths.astype(np.int64)
    codes = table.codes.astype(np.int64)
    for i, ln in enumerate(range(12, 17)):
        sel = np.flatnonzero(lengths == ln)
        if len(sel):
            out[i], out[5 + i], out[10 + i] = codes[sel[0]], codes[sel[-1]], sel[0]
    return out


def lane_tables(plan):
    """(lut11 [8, T11], huffval [8, 256], canon [8, 15]) int32; rows 0-3
    are the DC table slots, 4-7 the AC slots."""
    lut = np.zeros((8, T11), np.int32)
    hv = np.zeros((8, 256), np.int32)
    canon = np.zeros((8, 15), np.int32)
    for row in range(8):
        t = (plan.dc_tables if row < 4 else plan.ac_tables)[row % 4]
        if len(t.values) > 256:
            raise ValueError(f"Huffman table slot {row} has {len(t.values)} "
                             "values; the lane decoder holds 256")
        lut[row] = _lut11(t)
        hv[row, : len(t.values)] = t.values
        canon[row] = _canon_params(t)
    return lut, hv, canon


def _size_advance(sym, dc: bool):
    """(magnitude bits, advance of the coefficient index) of symbols: a DC
    symbol is its size and advances 1; an AC symbol's size is its low
    nibble, it advances run + 1, and EOB (64) ends the block."""
    sym = np.asarray(sym, np.int64)
    if dc:
        return sym, np.ones_like(sym)
    return sym & 0xF, np.where(sym == 0, 64, (sym >> 4) + 1)


def skip_entries(length, sym, dc: bool) -> np.ndarray:
    """Skip-table entries (int32) of codes of ``length`` bits decoding to
    ``sym`` in a DC (``dc``) or AC table. Bits 0-5: bits consumed, code and
    magnitude; 8-12: code length; 16-20: magnitude bits; 24-30: advance of
    the coefficient index (DC 1, EOB 64, else run + 1, so ZRL 16). The
    kernel's ``make_entry`` builds the same entries for codes longer than
    11 bits."""
    length = np.asarray(length, np.int64)
    size, adv = _size_advance(sym, dc)
    return ((length + size) | (length << 8) | (size << 16)
            | (adv << 24)).astype(np.int32)


def skip_table(lut_row: np.ndarray, dc: bool) -> np.ndarray:
    """[T11] int32 skip entries of one :func:`lane_tables` LUT row; 0 where
    the code is longer than 11 bits or the prefix is invalid."""
    length = lut_row & 0x1F
    entries = skip_entries(length, (lut_row >> 8) & 0xFF, dc)
    return np.where(length > 0, entries, 0).astype(np.int32)


def pair_entries(length, sym, dc: bool) -> np.ndarray:
    """Pass-1 entries (int32) of single codes: bits 0-5 bits consumed,
    6-12 advance of the coefficient index, and for a DC table 27-31 the code
    length (the DC magnitude follows it). The kernel's ``make_pair_entry``
    builds the same for codes longer than 11 bits."""
    length = np.asarray(length, np.int64)
    size, adv = _size_advance(sym, dc)
    return ((length + size) | (adv << 6)
            | ((length << 27) if dc else 0)).astype(np.int32)


def pair_table(lut_row: np.ndarray, dc: bool) -> np.ndarray:
    """[T11] int32, pass 1's table of one row: :func:`pair_entries` of the
    code at the top of each 11-bit peek, and in an AC row, where that code
    is not EOB and the next whole code and its magnitude bits also lie
    within the 11 bits, the pair: bits 13-18 bits both consume, 19-25 their
    advance, bit 26 set. 0 where the code is longer than 11 bits or the
    prefix is invalid."""
    length = lut_row & 0x1F
    sym = (lut_row >> 8) & 0xFF
    single = pair_entries(length, sym, dc).astype(np.int64)
    if not dc:
        bits1 = length + (sym & 0xF)
        second = (np.arange(T11) << np.minimum(bits1, 11)) & (T11 - 1)
        len2, sym2 = length[second], sym[second]
        bits2 = len2 + (sym2 & 0xF)
        both = ((length > 0) & (sym != 0) & (len2 > 0)
                & (bits1 + bits2 <= 11))
        adv = (single >> 6) & 0x7F
        adv2 = _size_advance(sym2, dc)[1]
        single |= np.where(both, ((bits1 + bits2) << 13)
                           | ((adv + adv2) << 19) | (1 << 26), 0)
    return np.where(length > 0, single, 0).astype(np.int32)


def kernel_tables(lut, hv, canon, slots):
    """The kernel's tables, cut to the R table rows that ``slots`` use:
    (skip [R, T11] for pass 2, pair [R, T11] for pass 1, huffval [R, 256],
    canon [R, 15], slots [bpm, 3] as (component, DC row, AC row) into them),
    all int32."""
    rows = sorted({int(d) for d in slots[:, 1]}
                  | {4 + int(a) for a in slots[:, 2]})
    at = {r: i for i, r in enumerate(rows)}
    skip = np.stack([skip_table(lut[r], r < 4) for r in rows])
    pair = np.stack([pair_table(lut[r], r < 4) for r in rows])
    kslots = np.array([(c, at[d], at[4 + a]) for c, d, a in slots], np.int32)
    return skip, pair, hv[rows], canon[rows], kslots


def slot_rows(plan) -> np.ndarray:
    """[bpm, 3] int32 per block slot of an MCU: (component, DC slot, AC slot)."""
    return np.array([(ci, plan.components[ci].dc_id, plan.components[ci].ac_id)
                     for ci, _ in plan.component_block_slots()], np.int32)


@dataclasses.dataclass
class LaneBatch:
    """Host-side launch arguments for one batch of plans."""

    data: np.ndarray        # [n] u8: every image's scan bytes, concatenated
    lane_start: np.ndarray  # [S] i64 first byte of each lane in ``data``
    lane_len: np.ndarray    # [S] i32 segment length in bytes
    lane_nblk: np.ndarray   # [S] i32 blocks to decode (mcu_count * bpm)
    lane_out: np.ndarray    # [S] i64 first output row of each lane
    lut11: np.ndarray
    huffval: np.ndarray
    canon: np.ndarray
    slots: np.ndarray       # [bpm, 3]
    skip: np.ndarray        # [R, T11] the kernel's tables (kernel_tables)
    pair: np.ndarray        # [R, T11]
    skip_hv: np.ndarray     # [R, 256]
    skip_canon: np.ndarray  # [R, 15]
    skip_slots: np.ndarray  # [bpm, 3]
    images: list            # per image: (first row, rows kept)
    total_rows: int


def prepare_lane_batch(plans: list) -> LaneBatch:
    """Lay out a batch of plans as lanes. Raises :class:`BatchMismatch` (a
    ``ValueError``) unless every image shares the first one's slot
    structure and Huffman tables, and for a segment of ``MAX_LANE_BYTES``
    or more."""
    if not plans:
        raise ValueError("empty batch")
    p0 = plans[0]
    slots = slot_rows(p0)
    tables = lane_tables(p0)
    for p in plans[1:]:
        if not np.array_equal(slot_rows(p), slots) or not all(
                np.array_equal(a, b) for a, b in zip(lane_tables(p), tables)):
            raise BatchMismatch(
                "in-kernel batch requires identical slot structure and "
                "Huffman tables across images")
    bpm = len(slots)
    starts, lens, nblk, outs, images, chunks = [], [], [], [], [], []
    byte_base = row = 0
    for p in plans:
        first = row
        for s in p.segments:
            if s.byte_end - s.byte_start >= MAX_LANE_BYTES:
                raise BatchMismatch("restart segment of "
                                 f"{s.byte_end - s.byte_start} bytes: the lane "
                                 f"decoder takes < {MAX_LANE_BYTES}")
            starts.append(byte_base + s.byte_start)
            lens.append(s.byte_end - s.byte_start)
            nblk.append(s.mcu_count * bpm)
            outs.append(row)
            row += s.mcu_count * bpm
        images.append((first, min(row - first, p.total_blocks)))
        chunks.append(np.asarray(p.scan_data, np.uint8))
        byte_base += len(p.scan_data)
    # The kernel reads a lane's bytes as three aligned 4-byte words from a
    # position clamped to the lane's end: 16 bytes of padding keep the last
    # lane's reads inside the buffer.
    chunks.append(np.zeros(16, np.uint8))
    skip, pair, skip_hv, skip_canon, skip_slots = kernel_tables(*tables, slots)
    return LaneBatch(
        data=np.concatenate(chunks),
        lane_start=np.array(starts, np.int64),
        lane_len=np.array(lens, np.int32),
        lane_nblk=np.array(nblk, np.int32),
        lane_out=np.array(outs, np.int64),
        lut11=tables[0], huffval=tables[1], canon=tables[2],
        slots=slots, skip=skip, pair=pair, skip_hv=skip_hv, skip_canon=skip_canon,
        skip_slots=skip_slots, images=images, total_rows=row)


def lane_tensors(batch: LaneBatch, device) -> dict:
    """The batch's arrays as tensors on ``device``, keyed by field name."""
    names = ("data", "lane_start", "lane_len", "lane_nblk", "lane_out",
             "lut11", "huffval", "canon", "slots", "skip", "pair", "skip_hv",
             "skip_canon", "skip_slots")
    return {n: torch.from_numpy(getattr(batch, n)).to(device) for n in names}


def _peek32(data, start, length, bitpos):
    """32 bits of each lane's stream at ``bitpos`` (bytes past the segment
    end read as 0xAA), as int64."""
    byte = bitpos >> 3
    acc = torch.zeros_like(bitpos)
    last = (length - 1).clamp(min=0)
    for j in range(5):
        pos = byte + j
        b = data[start + torch.minimum(pos, last)].to(torch.int64)
        acc = (acc << 8) | torch.where(pos < length, b, 0xAA)
    return (acc >> (8 - (bitpos & 7))) & 0xFFFFFFFF


def _resolve(lut, hv, canon, peek):
    """(length, symbol) per lane from one table row; length 0 = invalid."""
    e = lut[peek >> 21]
    length = e & 0x1F
    sym = (e >> 8) & 0xFF
    p16 = peek >> 16
    len_s = torch.zeros_like(length)
    idx = torch.zeros_like(length)
    for i in range(5):
        mn, mx, vp = (int(canon[j * 5 + i]) for j in range(3))
        if mx < 0:
            continue
        code = p16 >> (4 - i)
        hit = (code >= mn) & (code <= mx) & (len_s == 0)
        len_s = torch.where(hit, 12 + i, len_s)
        idx = torch.where(hit, vp + code - mn, idx)
    need = length == 0
    return torch.where(need, len_s, length), torch.where(need, hv[idx & 0xFF], sym)


def _magnitude(peek, length, nbits):
    """Bits [length, length + nbits) of ``peek``, sign-extended (Table F.2)."""
    raw = (peek >> (32 - length - nbits)) & ((1 << nbits) - 1)
    base = torch.where(nbits > 0, 1 << (nbits - 1).clamp(min=0), 0)
    val = torch.where(raw < base, raw - 2 * base + 1, raw)
    return torch.where(nbits > 0, val, 0)


def decode_block_plain(data, start, length, bitpos, active, dc_tab, ac_tab):
    """One block on every ``active`` lane, all in lockstep: the DC symbol,
    then AC symbols until every lane's block is done. ``dc_tab`` and
    ``ac_tab`` are (lut row, huffval row, canon row) of :func:`lane_tables`.
    Returns (block [S, 64] int64 zigzag, the DC difference at 0 (0 where the
    DC code was invalid); bad [S], the lanes that hit an invalid prefix in
    it; bitpos after it). A bad lane's block keeps what it decoded."""
    n_lanes = bitpos.shape[0]
    lanes = torch.arange(n_lanes, device=bitpos.device)
    block = torch.zeros((n_lanes, 64), dtype=torch.int64, device=bitpos.device)
    peek = _peek32(data, start, length, bitpos)
    ln, size = _resolve(*dc_tab, peek)
    bad = active & (ln == 0)
    ok = active & ~bad
    size = torch.where(ok, size, 0)
    block[:, 0] = _magnitude(peek, ln, size)
    bitpos = bitpos + torch.where(ok, ln + size, 0)
    coef = torch.where(ok, 1, 64)
    while True:
        busy = active & ~bad & (coef < 64)
        if not bool(busy.any()):
            break
        peek = _peek32(data, start, length, bitpos)
        ln, sym = _resolve(*ac_tab, peek)
        bad_ac = busy & (ln == 0)
        go = busy & ~bad_ac
        eob, zrl = sym == 0x00, sym == 0xF0
        nbits = torch.where(eob | zrl, 0, sym & 0xF)
        val = _magnitude(peek, ln, nbits)
        pos = coef + torch.minimum((sym >> 4) & 0xF, 63 - coef)
        write = go & ~eob & ~zrl
        block[lanes[write], pos[write]] = val[write]
        coef_next = torch.where(
            eob, 64, torch.where(zrl, (coef + 16).clamp(max=64), pos + 1))
        coef = torch.where(go, coef_next, coef)
        bitpos = bitpos + torch.where(go, ln + nbits, 0)
        bad = bad | bad_ac
    return block, bad, bitpos


def decode_lanes_plain(t: dict, n_lanes: int, total_rows: int):
    """Plain PyTorch K3 over the tensors of :func:`lane_tensors`: all lanes
    step through their blocks in lockstep (:func:`decode_block_plain`).
    Returns (coeffs [total_rows, 64] i32, err [S] bool)."""
    dev = t["data"].device
    i64 = torch.int64
    start, length = t["lane_start"], t["lane_len"].to(i64)
    nblk, out_row = t["lane_nblk"].to(i64), t["lane_out"]
    lut, hv = t["lut11"].to(i64), t["huffval"].to(i64)
    canon = t["canon"].cpu().tolist()
    slots = t["slots"].cpu().tolist()
    bpm = len(slots)
    coeffs = torch.zeros((total_rows, 64), dtype=torch.int32, device=dev)
    bitpos = torch.zeros(n_lanes, dtype=i64, device=dev)
    err = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    dc = torch.zeros((4, n_lanes), dtype=i64, device=dev)
    max_blk = int(nblk.max()) if n_lanes else 0
    for k in range(max_blk):
        active = ~err & (k < nblk)
        if not bool(active.any()):
            break
        comp, dcr, acr = slots[k % bpm]
        block, bad, bitpos = decode_block_plain(
            t["data"], start, length, bitpos, active,
            (lut[dcr], hv[dcr], canon[dcr]),
            (lut[4 + acr], hv[4 + acr], canon[4 + acr]))
        err = err | bad
        dc[comp] = dc[comp] + torch.where(active, block[:, 0], 0)
        block[:, 0] = dc[comp]
        rows = out_row[active] + k
        coeffs[rows] = block[active].to(torch.int32)
    err = err | (bitpos > length * 8 + 8)
    return coeffs, err


def _configure(lib) -> None:
    vp = ctypes.c_void_p
    lib.jt_huffman_lanes.restype = ctypes.c_int
    lib.jt_huffman_lanes.argtypes = [
        vp, vp, vp, vp, vp, ctypes.c_int32,  # data, lane arrays, n_lanes
        vp, vp, vp, vp, vp,  # skip, pair, skip_hv, skip_canon, skip_slots
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,  # rows, bpm, total_rows
        vp, vp, vp, vp,  # meta, coeffs, err, stream
    ]


def load_kernel():
    """Build (at first use) and load the K3 library."""
    return load_cuda_kernel("huffman_lanes", (), _configure,
                            headers=("huffman_common.cuh",))


def decode_lanes_cuda(t: dict, n_lanes: int, total_rows: int):
    """Launch K3's two passes on the current stream. Same contract as
    :func:`decode_lanes_plain`. Every output element is written once, so
    the outputs, and the per-block records the passes share (16 B a row),
    are allocated uninitialised."""
    dev = t["data"].device
    for name, x in t.items():
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"K3 input {name} must be contiguous on {dev}")
    lib = load_kernel()
    coeffs = torch.empty((total_rows, 64), dtype=torch.int32, device=dev)
    meta = torch.empty((total_rows, 4), dtype=torch.int32, device=dev)
    err = torch.empty(n_lanes, dtype=torch.uint8, device=dev)
    rc = lib.jt_huffman_lanes(
        t["data"].data_ptr(), t["lane_start"].data_ptr(),
        t["lane_len"].data_ptr(), t["lane_nblk"].data_ptr(),
        t["lane_out"].data_ptr(), n_lanes, t["skip"].data_ptr(),
        t["pair"].data_ptr(), t["skip_hv"].data_ptr(), t["skip_canon"].data_ptr(),
        t["skip_slots"].data_ptr(), t["skip"].shape[0],
        t["skip_slots"].shape[0], total_rows, meta.data_ptr(),
        coeffs.data_ptr(), err.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {rc}")
    LAUNCHES.add()
    return coeffs, err.bool()


def decode_lanes(t: dict, n_lanes: int, total_rows: int):
    """K3 wrapper: the plain version for CPU tensors, the kernel for CUDA
    tensors (no fallback between them)."""
    kind = t["data"].device.type
    if kind == "cpu":
        return decode_lanes_plain(t, n_lanes, total_rows)
    if kind == "cuda":
        return decode_lanes_cuda(t, n_lanes, total_rows)
    raise ValueError(f"K3 runs on cpu or cuda, not {t['data'].device}")


def decode_prepared_batch(batch: LaneBatch, device="cuda"):
    """Decode a :class:`LaneBatch` on ``device`` -> (list of
    ``[total_blocks, 64]`` int32 tensors, one per image, and ``err [S]``
    bool over all lanes in plan and segment order), both on ``device`` and
    not synchronised."""
    coeffs, err = decode_lanes(lane_tensors(batch, device),
                               len(batch.lane_start), batch.total_rows)
    return [coeffs[r0 : r0 + n] for r0, n in batch.images], err

