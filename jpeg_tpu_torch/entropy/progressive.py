"""Progressive (SOF2) entropy decode — JPEG F.2.2.

Beyond the reference (which panics on SOF2): successive-approximation and
spectral-selection scans accumulate quantized coefficients across scans; the
final coefficient tensor then flows through the same dense pipeline as
baseline (models/decoder) — progressive only changes the entropy stage.

Semantics follow the spec as implemented by libjpeg's jdphuff (DC first /
DC refine / AC first with EOB runs / AC refine with correction bits),
including restart-marker resets of predictors and the EOB run. Host-side
Python: clarity-first; the C++ runtime's progressive decoder is the fast
route, and ``engine="oracle"`` runs this one.

Copy of ``jpeg_tpu/entropy/progressive.py``.
"""

from __future__ import annotations

import numpy as np

from jpeg_tpu_torch.entropy.oracle import BitReader, decode_symbol
from jpeg_tpu_torch.entropy.tables import value_correction
from jpeg_tpu_torch.io.container import DecodePlan, JPEGError, ProgScan


def _comp_block_dims(plan: DecodePlan, ci: int) -> tuple[int, int]:
    """Non-interleaved block grid (JPEG A.2.2): exact component dims."""
    c = plan.components[ci]
    cw = -(-plan.width * c.h // plan.h_max)
    ch = -(-plan.height * c.v // plan.v_max)
    return -(-ch // 8), -(-cw // 8)


def _decode_dc_scan(plan, scan: ProgScan, state, reader_for, n_units,
                    unit_iter):
    """DC scan (ss == 0): interleaved MCU order (or single-comp raster)."""
    first = scan.ah == 0
    for seg_units, reader in reader_for():
        pred = [0] * len(scan.comp_indices)
        for u in seg_units:
            for si, (ci, by, bx) in unit_iter(u):
                dc = scan.dc_tables[scan.dc_ids[si]]
                if first:
                    nbits = decode_symbol(reader, dc)
                    diff = value_correction(reader.read_bits(nbits), nbits)
                    pred[si] += diff
                    state[ci][by, bx, 0] = pred[si] << scan.al
                else:
                    if reader.read_bits(1):
                        state[ci][by, bx, 0] |= 1 << scan.al


def _decode_ac_scan(plan, scan: ProgScan, state):
    """AC scan: single component, non-interleaved block raster."""
    if len(scan.comp_indices) != 1:
        raise JPEGError("progressive AC scan must have exactly one component")
    ci = scan.comp_indices[0]
    ac = scan.ac_tables[scan.ac_ids[0]]
    bh, bw = _comp_block_dims(plan, ci)
    n_blocks = bh * bw
    ri = scan.restart_interval or n_blocks
    ss, se, al = scan.ss, scan.se, scan.al
    first = scan.ah == 0
    p1 = 1 << al
    m1 = -1 << al
    blocks = state[ci]

    bi = 0
    for s0, s1 in scan.bounds:
        reader = BitReader(scan.scan_data[s0:s1])
        eobrun = 0
        for _ in range(min(ri, n_blocks - bi)):
            by, bx = divmod(bi, bw)
            coef = blocks[by, bx]
            if first:
                if eobrun > 0:
                    eobrun -= 1
                else:
                    k = ss
                    while k <= se:
                        rs = decode_symbol(reader, ac)
                        r, s = rs >> 4, rs & 0xF
                        if s == 0:
                            if r != 15:
                                eobrun = (1 << r) - 1
                                if r:
                                    eobrun += reader.read_bits(r)
                                break
                            k += 16  # ZRL
                        else:
                            k += r
                            if k > se:
                                break
                            coef[k] = value_correction(
                                reader.read_bits(s), s) << al
                            k += 1
            else:
                # AC refinement (libjpeg decode_mcu_AC_refine).
                k = ss
                if eobrun == 0:
                    while k <= se:
                        rs = decode_symbol(reader, ac)
                        r, s = rs >> 4, rs & 0xF
                        if s == 0:
                            if r != 15:
                                eobrun = 1 << r
                                if r:
                                    eobrun += reader.read_bits(r)
                                break
                            # r == 15: skip over 15 zero-history coeffs
                            s_val = 0
                        else:
                            if s != 1:
                                raise JPEGError(
                                    "invalid AC refinement magnitude")
                            s_val = p1 if reader.read_bits(1) else m1
                        # Advance to the target zero-history position,
                        # emitting correction bits for nonzero coeffs.
                        while k <= se:
                            if coef[k] != 0:
                                if reader.read_bits(1) and not (
                                    abs(int(coef[k])) & p1
                                ):
                                    coef[k] += p1 if coef[k] >= 0 else m1
                            else:
                                if r == 0:
                                    if s_val:
                                        coef[k] = s_val
                                    k += 1
                                    break
                                r -= 1
                            k += 1
                if eobrun > 0:
                    # Correction bits for the rest of the band.
                    while k <= se:
                        if coef[k] != 0:
                            if reader.read_bits(1) and not (
                                abs(int(coef[k])) & p1
                            ):
                                coef[k] += p1 if coef[k] >= 0 else m1
                        k += 1
                    eobrun -= 1
            bi += 1
        if bi >= n_blocks:
            break


def decode_progressive_coefficients(plan: DecodePlan) -> np.ndarray:
    """All scans -> [total_blocks, 64] int32, zigzag order, MCU stream order,
    final DC values — the same contract as the baseline entropy decoders, so
    the device pipelines apply unchanged."""
    if not plan.progressive:
        raise JPEGError("not a progressive plan")
    state = [
        np.zeros((plan.mcus_y * c.v, plan.mcus_x * c.h, 64), np.int64)
        for c in plan.components
    ]

    for scan in plan.prog_scans:
        if scan.ss == 0:
            if scan.se != 0:
                raise JPEGError(
                    "progressive DC scan must have se == 0 "
                    f"(got ss={scan.ss}, se={scan.se})"
                )
            _run_dc_scan(plan, scan, state)
        else:
            _decode_ac_scan(plan, scan, state)

    # Assemble MCU-interleaved stream order (vectorized).
    out = np.zeros((plan.total_blocks, 64), np.int32)
    slots = plan.component_block_slots()
    bpm = plan.blocks_per_mcu
    my, mx = np.divmod(np.arange(plan.n_mcus), plan.mcus_x)
    for si, (ci, sub) in enumerate(slots):
        c = plan.components[ci]
        vi, hi = divmod(sub, c.h)
        by = my * c.v + vi
        bx = mx * c.h + hi
        out[si::bpm] = state[ci][by, bx].astype(np.int32)
    return out


def _run_dc_scan(plan, scan: ProgScan, state):
    interleaved = len(scan.comp_indices) > 1
    if interleaved:
        n_units = plan.n_mcus
        ri = scan.restart_interval or n_units

        def unit_iter(u):
            my, mx = divmod(u, plan.mcus_x)
            out = []
            for si, ci in enumerate(scan.comp_indices):
                c = plan.components[ci]
                for vi in range(c.v):
                    for hi in range(c.h):
                        out.append((si, (ci, my * c.v + vi, mx * c.h + hi)))
            return [(si, pos) for si, pos in out]
    else:
        ci = scan.comp_indices[0]
        bh, bw = _comp_block_dims(plan, ci)
        n_units = bh * bw
        ri = scan.restart_interval or n_units

        def unit_iter(u):
            by, bx = divmod(u, bw)
            return [(0, (ci, by, bx))]

    def reader_for():
        start = 0
        for s0, s1 in scan.bounds:
            units = range(start, min(start + ri, n_units))
            yield units, BitReader(scan.scan_data[s0:s1])
            start += ri
            if start >= n_units:
                break

    _decode_dc_scan(plan, scan, state, reader_for, n_units, unit_iter)
