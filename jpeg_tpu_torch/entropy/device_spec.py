"""K7: speculative chunk-lane entropy decode on the card.

Counterpart of ``jpeg_tpu/entropy/device_spec.py``. A restart segment (the
whole scan, when there are none) is cut into byte-aligned chunks; each
chunk is a lane that decodes speculatively from its guessed start, and
Huffman self-synchronisation makes most guesses meet the true symbol
stream within a few MCUs (arXiv 2111.09219, as the C++ runtime's
``jt_decode_scan_planes_spec`` does on the host). Three phases:

1. **Phase A, on the card** (:func:`spec_lanes`): every lane decodes whole
   MCUs from its start, recording each MCU's start bit, the per-component
   DC prefix after it and how many it decoded whole, and keeps going
   ``overlap_mcus`` MCUs past its chunk end. The kernel is
   ``csrc/huffman_spec.cu`` (K7); :func:`spec_lanes_plain` is its plain
   PyTorch twin, which steps all lanes in lockstep.
2. **Host merge** (:func:`merge_lanes`, copied from the JAX module): per
   segment, chain sync points from chunk 0, whose start is true: the first
   position a lane and its successor both recorded is a true MCU boundary.
   Where a link is broken, the C++ ``jt_decode_gap`` decodes from the
   verified cursor until it lands on a position some later lane recorded
   (:func:`_host_gap_decode`). Only genuine corruption fails the merge.
   The merge reads the control arrays alone, which come to the host in
   one copy; the coefficients stay on the card. One repair against the
   JAX merge: a sync point is looked for only up to the segment's end
   (the JAX merge also takes a position two lanes reach by chance past
   it, and then fails a valid segment as corrupt).
3. **Relocate, on the card** (:func:`relocate`): a row gather puts the
   verified MCUs in stream order and a per-slot add corrects their DC.

Output contract, that of the restart-lane decoders: ``[total_blocks, 64]``
int32, zigzag order, DC predicted, MCU stream order.

:func:`spec_lanes` runs the plain version only for tensors on the CPU; for
CUDA tensors it launches K7 or raises. Nothing falls back to the host.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from jpeg_tpu_torch.entropy import device_huffman, oracle
from jpeg_tpu_torch.entropy.device_decode import check_luts, packed_luts
from jpeg_tpu_torch.io.container import DecodePlan
from jpeg_tpu_torch.runtime import native_decode_gap
from jpeg_tpu_torch.utils.build import LaunchCounter, load_cuda_kernel

# MCUs a lane keeps decoding past its chunk boundary, hunting for the
# successor's sync point (the JAX module's value; the host tier uses 96).
OVERLAP_MCUS = 24
PAD = 16  # bytes after the scan: the kernel's reader loads ahead, clamped

LAUNCHES = LaunchCounter()


def _chunk_lanes(plan: DecodePlan, target_lanes: int):
    """Split every restart segment into byte-aligned chunks totalling
    ~target_lanes lanes. Returns per-lane numpy arrays + per-segment
    grouping info."""
    segs = plan.segments
    total_bytes = sum(s.byte_end - s.byte_start for s in segs)
    lane_start, lane_chunk_end, lane_seg_end = [], [], []
    groups = []  # (segment, first_lane, n_chunks)
    for s in segs:
        nbytes = s.byte_end - s.byte_start
        k = max(1, min(
            round(target_lanes * nbytes / max(total_bytes, 1)),
            nbytes // 64 or 1))
        first = len(lane_start)
        for j in range(k):
            b0 = s.byte_start + nbytes * j // k
            b1 = s.byte_start + nbytes * (j + 1) // k
            lane_start.append(b0 * 8)
            lane_chunk_end.append(b1 * 8)
            lane_seg_end.append(s.byte_end * 8)
        groups.append((s, first, k))
    return (np.array(lane_start, np.int32),
            np.array(lane_chunk_end, np.int32),
            np.array(lane_seg_end, np.int32), groups)


def spec_cap(groups, overlap_mcus: int) -> int:
    """MCUs a lane may decode: the largest fair share of a chunk plus 30%
    for density skew (byte chunks equalise bits, not MCUs), plus the
    overlap. A lane that needs more ends early and gap recovery patches
    the difference."""
    max_chunk_mcus = 0
    for s, _first, k in groups:
        fair = -(-s.mcu_count // k)
        max_chunk_mcus = max(max_chunk_mcus,
                             min(s.mcu_count, (fair * 13 + 9) // 10 + 2))
    return max_chunk_mcus + overlap_mcus


def spec_tensors(plan: DecodePlan, lane_start, lane_chunk_end, lane_seg_end,
                 device, tables: str | None = None) -> dict:
    """Phase A's inputs on ``device``: the scan bytes (``PAD`` bytes of
    padding after them), the lanes' int32 bit positions, and the tables of
    the side that will read them: ``tables="kernel"`` K7's (``skip``,
    ``skip_hv``, ``skip_canon``, ``skip_slots``, as K3's), ``"plain"`` the
    plain version's (``lut11``, ``huffval``, ``canon``, ``slots``),
    ``"both"`` for a comparison of the two; by default the kernel's on a
    CUDA device, else the plain version's."""
    scan = np.asarray(plan.scan_data, np.uint8)
    if len(scan) >= (1 << 28):
        raise ValueError(f"scan of {len(scan)} bytes: K7's bit positions are "
                         "int32 (< 2^28 bytes)")
    if tables is None:
        tables = "kernel" if torch.device(device).type == "cuda" else "plain"
    if tables not in ("kernel", "plain", "both"):
        raise ValueError(f"unknown tables {tables!r}")
    slots = device_huffman.slot_rows(plan)
    lut, hv, canon = device_huffman.lane_tables(plan)
    arrays = dict(data=np.concatenate([scan, np.zeros(PAD, np.uint8)]),
                  bit_start=lane_start, chunk_end_bit=lane_chunk_end,
                  seg_end_bit=lane_seg_end)
    if tables != "plain":
        skip, _pair, skip_hv, skip_canon, skip_slots = (
            device_huffman.kernel_tables(lut, hv, canon, slots))
        arrays.update(skip=skip, skip_hv=skip_hv, skip_canon=skip_canon,
                      skip_slots=skip_slots)
    if tables != "kernel":
        arrays.update(lut11=lut, huffval=hv, canon=canon, slots=slots)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def spec_lanes_plain(t: dict, n_bytes: int, cap: int, overlap: int,
                     n_comp: int):
    """Plain PyTorch phase A over the tensors of :func:`spec_tensors`, every
    lane in lockstep (:func:`device_huffman.decode_block_plain`). Returns
    (out [S, cap * bpm, 64], mcu_bits [S, cap + 1], dc_cum [S, cap + 1,
    n_comp], n_dec [S]), int32, equal to K7's in every element: an entry a
    lane never reaches stays zero."""
    dev = t["data"].device
    i64 = torch.int64
    data = t["data"]
    n_lanes = t["bit_start"].shape[0]
    start = torch.zeros(n_lanes, dtype=i64, device=dev)
    # A lane reads its segment's bytes, then 0xAA fill (F8): as the C++
    # decoder and K3 read a restart segment.
    length = t["seg_end_bit"].to(i64) >> 3
    lut, hv = t["lut11"].to(i64), t["huffval"].to(i64)
    canon = t["canon"].cpu().tolist()
    slots = t["slots"].cpu().tolist()
    bpm = len(slots)
    out = torch.zeros((n_lanes, cap * bpm, 64), dtype=torch.int32, device=dev)
    mcu_bits = torch.zeros((n_lanes, cap + 1), dtype=torch.int32, device=dev)
    dc_cum = torch.zeros((n_lanes, cap + 1, n_comp), dtype=torch.int32,
                         device=dev)
    n_dec = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    bitpos = t["bit_start"].to(i64)
    chunk_end, seg_end = t["chunk_end_bit"].to(i64), t["seg_end_bit"].to(i64)
    alive = torch.ones(n_lanes, dtype=torch.bool, device=dev)
    past_end = torch.zeros(n_lanes, dtype=i64, device=dev)
    pred = torch.zeros((n_comp, n_lanes), dtype=i64, device=dev)
    for m in range(cap):
        if not bool(alive.any()):
            break
        mcu_bits[alive, m] = bitpos[alive].to(torch.int32)
        past_end = past_end + (alive & (bitpos >= chunk_end)).to(i64)
        start_ok = alive & (bitpos < seg_end) & (past_end <= overlap)
        ok = start_ok
        for slot, (comp, dcr, acr) in enumerate(slots):
            block, bad, bitpos = device_huffman.decode_block_plain(
                data, start, length, bitpos, ok,
                (lut[dcr], hv[dcr], canon[dcr]),
                (lut[4 + acr], hv[4 + acr], canon[4 + acr]))
            ok = ok & ~bad
            # i32 wrap, as the kernel adds.
            dc = (pred[comp] + block[:, 0] + (1 << 31)) % (1 << 32) - (1 << 31)
            pred[comp] = torch.where(ok, dc, pred[comp])
            block[:, 0] = pred[comp]
            out[ok, m * bpm + slot] = block[ok].to(torch.int32)
        dc_cum[start_ok, m + 1] = pred[:, start_ok].T.to(torch.int32)
        alive = ok
        n_dec += alive.to(torch.int32)
    mcu_bits[alive, cap] = bitpos[alive].to(torch.int32)
    return out, mcu_bits, dc_cum, n_dec


def _configure(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.jt_huffman_spec.restype = ctypes.c_int
    lib.jt_huffman_spec.argtypes = [
        vp, i32, vp, vp, vp, i32,  # data, n_bytes, lane arrays, n_lanes
        vp, vp, vp, vp,  # skip, huffval, canon, slots
        i32, i32, i32, i32, i32,  # n_rows, bpm, n_comp, cap, overlap
        vp, vp, vp, vp, vp,  # out, mcu_bits, dc_cum, n_dec, stream
    ]


def load_kernel():
    """Build (at first use) and load the K7 library."""
    return load_cuda_kernel("huffman_spec", (), _configure,
                            headers=("huffman_common.cuh",))


def spec_lanes_cuda(t: dict, n_bytes: int, cap: int, overlap: int,
                    n_comp: int):
    """Launch K7 on the current stream. Same contract as
    :func:`spec_lanes_plain`; ``out``, ``mcu_bits`` and ``dc_cum`` are
    zeroed here, the kernel writes the entries its lanes reach."""
    dev = t["data"].device
    for name, x in t.items():
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"K7 input {name} must be contiguous on {dev}")
    if t["data"].numel() < n_bytes + PAD:
        raise ValueError(f"K7 reads {PAD} bytes past the scan's {n_bytes}")
    lib = load_kernel()
    n_lanes = t["bit_start"].shape[0]
    bpm = t["skip_slots"].shape[0]
    out = torch.zeros((n_lanes, cap * bpm, 64), dtype=torch.int32, device=dev)
    mcu_bits = torch.zeros((n_lanes, cap + 1), dtype=torch.int32, device=dev)
    dc_cum = torch.zeros((n_lanes, cap + 1, n_comp), dtype=torch.int32,
                         device=dev)
    n_dec = torch.empty(n_lanes, dtype=torch.int32, device=dev)
    rc = lib.jt_huffman_spec(
        t["data"].data_ptr(), n_bytes, t["bit_start"].data_ptr(),
        t["chunk_end_bit"].data_ptr(), t["seg_end_bit"].data_ptr(), n_lanes,
        t["skip"].data_ptr(), t["skip_hv"].data_ptr(),
        t["skip_canon"].data_ptr(), t["skip_slots"].data_ptr(),
        t["skip"].shape[0], bpm, n_comp, cap, overlap, out.data_ptr(),
        mcu_bits.data_ptr(), dc_cum.data_ptr(), n_dec.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K7 launch failed: CUDA error {rc}")
    LAUNCHES.add()
    return out, mcu_bits, dc_cum, n_dec


def spec_lanes(t: dict, n_bytes: int, cap: int, overlap: int, n_comp: int):
    """K7 wrapper: the plain version for CPU tensors, the kernel for CUDA
    tensors (no fallback between them)."""
    kind = t["data"].device.type
    if kind == "cpu":
        return spec_lanes_plain(t, n_bytes, cap, overlap, n_comp)
    if kind == "cuda":
        return spec_lanes_cuda(t, n_bytes, cap, overlap, n_comp)
    raise ValueError(f"K7 runs on cpu or cuda, not {t['data'].device}")


def control_to_host(mcu_bits, dc_cum, n_dec):
    """The three control arrays as numpy, through one device-to-host copy."""
    flat = torch.cat([mcu_bits.flatten(), dc_cum.flatten(), n_dec]).cpu().numpy()
    a, b = mcu_bits.numel(), mcu_bits.numel() + dc_cum.numel()
    return (flat[:a].reshape(mcu_bits.shape), flat[a:b].reshape(dc_cum.shape),
            flat[b:])


def _oracle_gap_decode(plan, start_bit, prev_dc, later, n_mcus_left):
    """Plain version of :func:`_host_gap_decode` on the NumPy oracle (the
    JAX module's no-native loop): the same contract, held to it by the
    tests. Reads the scan past the segment end, where the C++ decoder
    reads 0xAA."""
    slots = plan.component_block_slots()
    reader = oracle.BitReader(plan.scan_data[start_bit // 8:])
    reader.consume(start_bit & 7)
    byte0 = (start_bit // 8) * 8
    dc = prev_dc.copy()
    blocks = []
    while True:
        pos = byte0 + reader.bit_position
        resume = _resume_at(later, pos)
        if resume is not None:
            return (np.array(blocks, np.int32).reshape(
                len(blocks), len(slots), 64), dc, resume, len(blocks))
        if len(blocks) >= n_mcus_left:
            return (np.array(blocks, np.int32).reshape(
                len(blocks), len(slots), 64), dc, None, len(blocks))
        mcu = np.zeros((len(slots), 64), np.int32)
        try:
            for si, (ci, _sub) in enumerate(slots):
                comp = plan.components[ci]
                block = oracle.next_block(
                    reader, plan.ac_tables[comp.ac_id],
                    plan.dc_tables[comp.dc_id])
                block[0] += dc[ci]
                dc[ci] = block[0]
                mcu[si] = block
        except ValueError:
            return None
        blocks.append(mcu)


def _host_gap_decode(plan, start_bit, prev_dc, later, n_mcus_left,
                     seg_end_byte):
    """Sequentially decode MCUs from absolute bit position ``start_bit``
    (a verified MCU boundary within ``plan.scan_data``) with the C++
    ``jt_decode_gap`` until the cursor lands on a recorded MCU start of one
    of ``later`` lanes or ``n_mcus_left`` MCUs are decoded. Returns
    (blocks [g, bpm, 64] i32 absolute-DC, dc_after, resume (ci, idx) |
    None, g) or None on an invalid prefix (genuine stream corruption).

    ``later`` is (stop_pos sorted i64, stop_lane i32, stop_idx i32):
    the recorded MCU-start positions of all lanes AFTER the broken one,
    with their owning chunk index and lane-local record index."""
    slots = plan.component_block_slots()
    stop_pos, _stop_lane, _stop_idx = later
    res = native_decode_gap(plan, int(start_bit), int(seg_end_byte),
                            stop_pos, int(n_mcus_left))
    if res is None:
        return None
    blocks, pos = res
    g = len(blocks)
    dc = prev_dc.copy()
    if g:
        # DC prediction per component over the slot-major stream.
        flat = blocks.reshape(g * len(slots), 64)
        for c in range(len(plan.components)):
            mask = np.fromiter(
                (ci == c for ci, _ in slots), bool).astype(np.int64)
            deltas = flat[:, 0].astype(np.int64) * np.tile(mask, g)
            run = np.cumsum(deltas) + dc[c]
            sel = np.tile(mask, g).astype(bool)
            flat[sel, 0] = run[sel].astype(np.int32)
            if sel.any():
                dc[c] = run[np.where(sel)[0][-1]]
    final_pos = int(pos[g - 1]) if g else int(start_bit)
    resume = None
    if g < n_mcus_left:
        resume = _resume_at(later, final_pos)
        if resume is None:
            return None  # stopped without a stop hit: corruption
    return blocks, dc, resume, g


def _resume_at(later, pos):
    """(chunk index, lane-local record index) of the earliest later lane
    that recorded bit position ``pos``, or None."""
    stop_pos, stop_lane, stop_idx = later
    lo = np.searchsorted(stop_pos, pos)
    hi = np.searchsorted(stop_pos, pos, side="right")
    if lo == hi:
        return None
    j = lo + int(np.argmin(stop_lane[lo:hi]))
    return int(stop_lane[j]), int(stop_idx[j])


def _merge_segment(plan, seg, first, k, mcu_bits, dc_cum, n_dec, m0, cap,
                   n_comp):
    """Chain sync points for one segment's chunk lanes. Returns
    (src_rows [n_mcus_seg] global rows into the flattened [S*cap] lane-MCU
    axis, corr [n_mcus_seg, n_comp] DC corrections, patch_mcus,
    patch_blocks, gap_mcus) or None when gap recovery itself hits an
    invalid prefix (genuine corruption — caller falls back to the host
    tier). Lane-local MCU j lives at column m0[lane]+j. A broken sync link
    — the successor never recorded any of this lane's verified MCU starts
    — is bridged by :func:`_host_gap_decode`: the host decodes from the
    verified end cursor until it hits a recorded MCU start of ANY later
    lane (same self-sync argument as lane chaining: a shared bit position
    at MCU phase makes the two parses identical from there on), and those
    few MCUs are patched into the device output."""
    n_mcus = seg.mcu_count
    bpm = plan.blocks_per_mcu
    src = np.zeros(n_mcus, np.int64)
    corr = np.zeros((n_mcus, n_comp), np.int32)
    patch_mcus, patch_blocks = [], []
    gap_mcus = 0
    base = np.zeros(n_comp, np.int64)

    # One sorted (position, chunk, record-index) table for the whole
    # segment, built lazily at the first broken link; gap events slice
    # it by chunk index instead of rebuilding per-event dicts.
    stop_table = None

    def later_stops(ci):
        nonlocal stop_table
        if stop_table is None:
            parts_p, parts_l, parts_i = [], [], []
            for c in range(k):
                lane = first + c
                o, nd = int(m0[lane]), int(n_dec[lane])
                p = mcu_bits[lane, o: o + nd + 1].astype(np.int64)
                parts_p.append(p)
                parts_l.append(np.full(len(p), c, np.int32))
                parts_i.append(np.arange(len(p), dtype=np.int32))
            pos = np.concatenate(parts_p)
            lane_arr = np.concatenate(parts_l)
            idx = np.concatenate(parts_i)
            order = np.argsort(pos, kind="stable")
            stop_table = (pos[order], lane_arr[order], idx[order])
        pos, lane_arr, idx = stop_table
        m = lane_arr > ci
        return pos[m], lane_arr[m], idx[m]

    ci, j0, mcu_base = 0, 0, 0
    while mcu_base < n_mcus:
        lane = first + ci
        nd = int(n_dec[lane])
        o = int(m0[lane])
        a = mcu_bits[lane, o: o + nd + 1]
        sync = None
        if ci + 1 < k:
            nxt = first + ci + 1
            b = mcu_bits[nxt, int(m0[nxt]):
                         int(m0[nxt]) + int(n_dec[nxt]) + 1]
            # First recorded position common to this lane (at/after its
            # handoff index, up to the segment's end) and its successor.
            # Positions are strictly increasing per lane, so the smallest
            # common value is the earliest sync in both. Past the segment's
            # last MCU both lanes decode the padding and the next segment's
            # bytes, where two of them may meet by chance: such a position
            # is no MCU start of this segment (the JAX merge takes it and
            # fails the segment as corrupt).
            common, ai, bi = np.intersect1d(
                a[j0: j0 + n_mcus - mcu_base + 1], b, return_indices=True)
            if len(common):
                sync = (j0 + int(ai[0]), int(bi[0]))
        if sync is not None:
            take = sync[0] - j0
            if take < 0 or mcu_base + take > n_mcus:
                return None  # mis-sync past segment end: corruption
        else:
            # Broken link or final lane: keep everything this lane
            # verified (overlap MCUs included), then bridge on the host.
            take = min(nd - j0, n_mcus - mcu_base)
            if take < 0:
                return None
        rows = lane * cap + o + np.arange(j0, j0 + take)
        src[mcu_base: mcu_base + take] = rows
        corr[mcu_base: mcu_base + take] = (
            base - dc_cum[lane, o + j0]).astype(np.int32)
        base = (base + dc_cum[lane, o + j0 + take].astype(np.int64)
                - dc_cum[lane, o + j0])
        mcu_base += take
        if sync is not None:
            ci, j0 = ci + 1, sync[1]
            continue
        if mcu_base >= n_mcus:
            break
        gap = _host_gap_decode(
            plan, int(a[j0 + take]), base, later_stops(ci),
            n_mcus - mcu_base, seg.byte_end)
        if gap is None:
            return None
        g_blocks, base, resume, g = gap
        if g:
            patch_mcus.extend(range(mcu_base, mcu_base + g))
            patch_blocks.append(g_blocks.reshape(g * bpm, 64))
            gap_mcus += g
            mcu_base += g
        if resume is None:
            break
        ci, j0 = resume
    if mcu_base != n_mcus:
        return None
    return src, corr, patch_mcus, patch_blocks, gap_mcus


def merge_lanes(plan: DecodePlan, groups, mcu_bits, dc_cum, n_dec, cap: int,
                stats: dict):
    """The host merge over every segment (numpy control arrays) ->
    (src_rows [n_mcus] int64, corr [n_mcus, n_comp] int32, patch_rows,
    patch_blocks), or None when a chain breaks. Counts ``merged``,
    ``failed`` and ``gap_mcus`` into ``stats``."""
    bpm = plan.blocks_per_mcu
    m0 = np.zeros(len(n_dec), np.int32)
    srcs, corrs = [], []
    patch_rows, patch_blocks = [], []
    mcu_off = 0
    for s, first, k in groups:
        m = _merge_segment(plan, s, first, k, mcu_bits, dc_cum, n_dec, m0,
                           cap, len(plan.components))
        if m is None:
            stats["failed"] += 1
            return None
        stats["merged"] += 1
        src_s, corr_s, pm, pb, gaps = m
        stats["gap_mcus"] += gaps
        srcs.append(src_s)
        corrs.append(corr_s)
        for mi in pm:
            patch_rows.extend(
                range((mcu_off + mi) * bpm, (mcu_off + mi + 1) * bpm))
        patch_blocks.extend(pb)
        mcu_off += s.mcu_count
    return np.concatenate(srcs), np.concatenate(corrs), patch_rows, patch_blocks


def relocate(plan: DecodePlan, out, src_rows, corr, patch_rows, patch_blocks):
    """Phase A's rows in stream order on ``out``'s device: one row gather
    of the verified MCUs, the DC corrections added per slot, the gap MCUs
    written over their rows -> ``[total_blocks, 64]`` int32."""
    dev = out.device
    n_lanes, rows_per_lane, _ = out.shape
    bpm = plan.blocks_per_mcu
    slot_comp = [ci for ci, _ in plan.component_block_slots()]
    src = torch.from_numpy(src_rows).to(dev)
    rows = out.reshape(n_lanes * rows_per_lane // bpm, bpm, 64)[src]
    rows[:, :, 0] += torch.from_numpy(corr).to(dev)[:, slot_comp]
    coeffs = rows.reshape(-1, 64)[: plan.total_blocks]
    if patch_rows:
        idx = np.array(patch_rows, np.int64)
        keep = idx < coeffs.shape[0]  # rows past the frame are dropped
        coeffs[torch.from_numpy(idx[keep]).to(dev)] = torch.from_numpy(
            np.concatenate(patch_blocks)[keep]).to(dev)
    return coeffs


def decode_coefficients_device_spec(plan: DecodePlan, target_lanes=2048,
                                    overlap_mcus=OVERLAP_MCUS, luts=None,
                                    pair=False, device="cuda"):
    """Speculative chunk-lane entropy decode with K7 on ``device`` ->
    (``[total_blocks, 64]`` int32 tensor on ``device``, stats) or
    (None, stats) when a sync chain broke (the caller decodes on the host
    tier).

    ``stats`` holds ``lanes``, ``cap`` and the merge outcome (``merged``,
    ``failed``, ``gap_mcus``), as in the JAX package. ``pair`` selects the
    JAX package's pair-symbol kernel there; here K7 answers both, and
    ``luts``, if given, must equal the tables the JAX function would build
    (``pair_luts(plan)[0]`` with ``pair``, else ``packed_luts(plan)``):
    ``ValueError`` before anything is launched."""
    if luts is not None:
        if pair:
            from jpeg_tpu_torch.entropy.device_pair import pair_luts

            check_luts(luts, pair_luts(plan)[0], "pair_luts")
        else:
            check_luts(luts, packed_luts(plan), "packed_luts")
    lane_start, lane_chunk_end, lane_seg_end, groups = _chunk_lanes(
        plan, target_lanes)
    cap = spec_cap(groups, overlap_mcus)
    t = spec_tensors(plan, lane_start, lane_chunk_end, lane_seg_end, device)
    out, mcu_bits, dc_cum, n_dec = spec_lanes(
        t, len(plan.scan_data), cap, overlap_mcus, len(plan.components))
    stats = {"lanes": len(lane_start), "cap": cap, "merged": 0, "failed": 0,
             "gap_mcus": 0}
    merged = merge_lanes(plan, groups, *control_to_host(mcu_bits, dc_cum, n_dec),
                         cap, stats)
    if merged is None:
        return None, stats
    return relocate(plan, out, *merged), stats
