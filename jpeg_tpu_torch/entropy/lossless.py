"""Lossless JPEG (SOF3, T.81 Annex H): decode + encode.

Counterpart of ``jpeg_tpu/entropy/lossless.py``: the difference decoder
(:func:`decode_diffs`, pure Python as in the JAX package), the sequential
reconstruction (:func:`reconstruct`), the prefix-sum reconstruction of
predictors 1 and 2 on a torch device (:func:`reconstruct_device`, two
``torch.cumsum`` a component), :func:`decode_lossless` with the C++ runtime
(``jt_decode_lossless``, or ``jt_decode_lossless_diffs`` before the
reconstruction on the device) or this module as its engine, and
:func:`encode_lossless`, copied with its ``predictor="auto"`` selection.
The port's tests hold each to the JAX function bit for bit.

Semantics (T.81 H.1.2, samples in the point-transform domain
``sample >> Pt``; output shifts back by Pt):

* predictors 1..7: Ra (left), Rb (above), Rc (above-left),
  4: Ra+Rb-Rc, 5: Ra+((Rb-Rc)>>1), 6: Rb+((Ra-Rc)>>1), 7: (Ra+Rb)>>1;
  all arithmetic mod 2^16.
* the first sample of the scan AND of each restart interval predicts
  from ``1 << (P - Pt - 1)``;
* the remainder of the scan's (or restart interval's) first line uses
  Ra; the first sample of every other line uses Rb; everything else
  uses the selected predictor.
* Huffman: DC-style tables over difference categories SSSS 0..16;
  SSSS == 16 means diff = 32768 with NO extra bits (H.2 Table H.2).

Predictors 1 and 2 of a scan without restart intervals are prefix sums
(:func:`reconstruct_device`); the others are 2-D recurrences, and a restart
interval resets the prediction mid-line, so those take the C++ runtime or
:func:`reconstruct` (the JAX package's contract, not a fallback).
"""

from __future__ import annotations

import numpy as np

import torch

from jpeg_tpu_torch.entropy.oracle import BitReader, decode_symbol
from jpeg_tpu_torch.io.container import DecodePlan, JPEGError
from jpeg_tpu_torch.runtime import (native_decode_lossless,
                                    native_decode_lossless_diffs)

M16 = 0xFFFF


def _extend(v: int, ssss: int) -> int:
    """JPEG Table F.2 sign extension (diff magnitude categories)."""
    if ssss == 0:
        return 0
    return v if v >= (1 << (ssss - 1)) else v - (1 << ssss) + 1


def decode_diffs(plan: DecodePlan) -> np.ndarray:
    """Entropy-decode the scan -> raw prediction differences
    [H, W, ncomp] int32 (mod-2^16 semantics applied at reconstruction).
    """
    ncomp = len(plan.components)
    W, H = plan.width, plan.height
    diffs = np.zeros((H * W, ncomp), np.int32)
    tables = [plan.dc_tables[c.dc_id] for c in plan.components]
    for seg in plan.segments:
        reader = BitReader(plan.scan_data[seg.byte_start : seg.byte_end])
        for m in range(seg.mcu_start, seg.mcu_start + seg.mcu_count):
            for ci in range(ncomp):
                ssss = decode_symbol(reader, tables[ci])
                if ssss > 16:
                    raise JPEGError(
                        f"invalid lossless difference category {ssss}")
                if ssss == 16:
                    diffs[m, ci] = 32768  # H.2: no additional bits
                else:
                    diffs[m, ci] = _extend(reader.read_bits(ssss), ssss)
    return diffs.reshape(H, W, ncomp)


def _predict(rec, y, x, ci, predictor, default, first_y, first_m, W):
    """T.81 H.1.2.2 boundary rules + H.1.2.1 predictors, one sample."""
    m = y * W + x
    if m == first_m:
        return default
    if y == first_y:  # remainder of the scan/interval's first line
        return int(rec[y, x - 1, ci])
    if x == 0:
        return int(rec[y - 1, x, ci])
    ra = int(rec[y, x - 1, ci])
    rb = int(rec[y - 1, x, ci])
    rc = int(rec[y - 1, x - 1, ci])
    if predictor == 1:
        return ra
    if predictor == 2:
        return rb
    if predictor == 3:
        return rc
    if predictor == 4:
        return ra + rb - rc
    if predictor == 5:
        return ra + ((rb - rc) >> 1)
    if predictor == 6:
        return rb + ((ra - rc) >> 1)
    return (ra + rb) >> 1  # predictor 7


def reconstruct(plan: DecodePlan, diffs: np.ndarray) -> np.ndarray:
    """Sequential oracle reconstruction -> [H, W, ncomp] uint16 samples
    (left-shifted back by the point transform)."""
    W, H = plan.width, plan.height
    ncomp = len(plan.components)
    pt = plan.point_transform
    default = 1 << (plan.precision - pt - 1)
    rec = np.zeros((H, W, ncomp), np.int32)
    d = diffs.reshape(H * W, ncomp)
    for seg in plan.segments:
        first_m = seg.mcu_start
        first_y = first_m // W
        for m in range(first_m, first_m + seg.mcu_count):
            y, x = divmod(m, W)
            for ci in range(ncomp):
                px = _predict(rec, y, x, ci, plan.predictor, default,
                              first_y, first_m, W)
                rec[y, x, ci] = (px + int(d[m, ci])) & M16
    return (rec.astype(np.uint16) << pt).astype(np.uint16)


def cumsum_takes(plan: DecodePlan) -> bool:
    """Whether :func:`reconstruct_device` reconstructs the plan: predictor
    1 or 2 in a scan without restart intervals."""
    return plan.predictor in (1, 2) and len(plan.segments) == 1


def reconstruct_device(plan: DecodePlan, diffs: np.ndarray, device="cuda"):
    """Reconstruction of predictors 1 and 2 (restart-free scans) on
    ``device``: the prediction recurrences are exact prefix sums, so the
    image reconstructs as two ``torch.cumsum`` (mod 2^16). Returns a
    ``[H, W, ncomp]`` uint16 tensor on ``device``, or None when the plan
    needs the sequential reconstruction (:func:`cumsum_takes` is false).

    ``torch.cumsum`` of int32 sums in int64; the sums are masked to 16 bits
    before the point-transform shift and again after it, and narrowed by
    one ``.to(torch.uint16)``, as ``(rec & M16).astype(uint16) << pt``
    wraps in the JAX package."""
    if not cumsum_takes(plan):
        return None
    pt = plan.point_transform
    default = 1 << (plan.precision - pt - 1)
    d = torch.as_tensor(np.asarray(diffs, np.int32), device=device)
    if plan.predictor == 1:
        # Row chain: row starts predict from the row above's start
        # (first-line / first-column rules), so column 0 is a vertical
        # cumsum of row-start diffs; each row is a horizontal cumsum.
        col0 = torch.cumsum(d[:, 0, :], dim=0) + default  # [H, C]
        rows = torch.cumsum(d[:, 1:, :], dim=1)  # [H, W-1, C]
        rec = torch.cat([col0[:, None, :], col0[:, None, :] + rows], dim=1)
    else:
        # Predictor 2 (Rb): the first line uses Ra (horizontal cumsum),
        # then every column is a vertical cumsum.
        row0 = torch.cumsum(d[0], dim=0) + default  # [W, C]
        cols = torch.cumsum(d[1:], dim=0)  # [H-1, W, C]
        rec = torch.cat([row0[None], row0[None] + cols], dim=0)
    return (((rec & M16) << pt) & M16).to(torch.uint16)


def decode_lossless(plan: DecodePlan, device="cuda",
                    engine: str = "auto") -> np.ndarray:
    """SOF3 scan -> ``[H, W, ncomp]`` uint16 samples (numpy).

    ``device`` (default ``"cuda"``, the JAX package's ``device=True``):
    reconstruct predictor-1/2 restart-free scans with
    :func:`reconstruct_device` there, from differences decoded by
    ``engine``; other scans take ``engine`` alone. ``device=None`` is the
    JAX package's ``device=False``: ``engine`` alone. ``engine``:
    ``"auto"`` or ``"native"`` (C++: ``jt_decode_lossless_diffs`` for the
    device route, ``jt_decode_lossless`` otherwise; differences parallel
    over restart segments, prediction in order; a failed build raises) or
    ``"oracle"`` (:func:`decode_diffs`, then :func:`reconstruct` off the
    device route)."""
    if not plan.lossless:
        raise JPEGError("decode_lossless requires an SOF3 plan")
    if engine not in ("auto", "native", "oracle"):
        raise ValueError(f"unknown engine {engine!r}")
    if device is not None and cumsum_takes(plan):
        diffs = (decode_diffs(plan) if engine == "oracle"
                 else native_decode_lossless_diffs(plan))
        return reconstruct_device(plan, diffs, device).cpu().numpy()
    if engine != "oracle":
        return native_decode_lossless(plan)
    return reconstruct(plan, decode_diffs(plan))


# ---------------------------------------------------------------------------
# Encoder


def _interior_diffs(dom: np.ndarray, predictor: int) -> np.ndarray:
    """Interior prediction differences (mod-2^16, signed window) of a
    Pt-domain image for one selector — the predictor="auto" cost proxy
    (boundary samples are a vanishing fraction)."""
    ra = dom[1:, :-1]
    rb = dom[:-1, 1:]
    rc = dom[:-1, :-1]
    if predictor == 1:
        px = ra
    elif predictor == 2:
        px = rb
    elif predictor == 3:
        px = rc
    elif predictor == 4:
        px = ra + rb - rc
    elif predictor == 5:
        px = ra + ((rb - rc) >> 1)
    elif predictor == 6:
        px = rb + ((ra - rc) >> 1)
    else:
        px = (ra + rb) >> 1
    d = (dom[1:, 1:] - px) & M16
    return np.where(d >= 32768, d - 65536, d)


def _pack_bits(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """MSB-first pack of per-symbol bit fields (<= 32 bits each) into
    bytes: 1-padded to a byte boundary (F.1.2.3) and 0xFF00-stuffed
    (B.1.1.5). Vectorized: one scatter pass per bit position instead of
    a python call per symbol."""
    lens = lens.astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    total = int(offs[-1])
    nbits = -(-total // 8) * 8
    bits = np.ones(nbits, np.uint8)  # 1-fill doubles as the pad
    maxlen = int(lens.max(initial=0))
    for b in range(maxlen):
        sel = lens > b
        bits[offs[:-1][sel] + b] = (
            (vals[sel] >> (lens[sel] - 1 - b).astype(np.uint64)) & 1
        ).astype(np.uint8)
    raw = np.packbits(bits)
    ff = np.flatnonzero(raw == 0xFF)
    if len(ff):
        raw = np.insert(raw, ff + 1, 0)
    return raw.tobytes()


def prediction_differences(dom: np.ndarray, predictor: int, default: int,
                           restart_interval: int = 0) -> np.ndarray:
    """Prediction differences of a point-transform-domain image ``dom``
    [H, W, C] -> [H * W, C] int32 in [0, 2^16): what :func:`encode_lossless`
    codes and :func:`reconstruct` inverts. The encoder's prediction has no
    sequential dependency (the reconstruction equals the source), so the
    whole prediction map vectorizes; the H.1.2.2 boundary rules (scan and
    interval starts, first lines) patch in afterwards."""
    H, W, ncomp = dom.shape
    n = H * W
    ri = restart_interval or n
    pred = np.empty((H, W, ncomp), np.int64)
    pred[0, 0] = default
    pred[0, 1:] = dom[0, :-1]  # first line: Ra
    pred[1:, 0] = dom[:-1, 0]  # other rows' first sample: Rb
    ra = dom[1:, :-1].astype(np.int64)
    rb = dom[:-1, 1:].astype(np.int64)
    rc = dom[:-1, :-1].astype(np.int64)
    if predictor == 1:
        interior = ra
    elif predictor == 2:
        interior = rb
    elif predictor == 3:
        interior = rc
    elif predictor == 4:
        interior = ra + rb - rc
    elif predictor == 5:
        interior = ra + ((rb - rc) >> 1)
    elif predictor == 6:
        interior = rb + ((ra - rc) >> 1)
    else:
        interior = (ra + rb) >> 1
    pred[1:, 1:] = interior
    if restart_interval:
        flat_dom = dom.reshape(n, ncomp)
        flat_pred = pred.reshape(n, ncomp)
        for s0 in range(0, n, ri):
            flat_pred[s0] = default  # interval start
            # rest of the interval's first line: Ra
            row_end = min((s0 // W + 1) * W, s0 + ri, n)
            if s0 + 1 < row_end:
                flat_pred[s0 + 1 : row_end] = flat_dom[s0 : row_end - 1]
    diffs = ((dom.astype(np.int64) - pred) & M16).reshape(n, ncomp)
    return diffs.astype(np.int32)


def encode_lossless(samples: np.ndarray, predictor: int | str = 1,
                    point_transform: int = 0, precision: int | None = None,
                    restart_interval: int = 0) -> bytes:
    """[H, W] or [H, W, C<=4] unsigned samples -> SOF3 JFIF-style bytes.

    ``restart_interval`` counts MCUs (= sample positions). Per-image
    optimal Huffman tables (Annex K.2) over the difference categories.
    ``predictor="auto"`` picks the selector with the smallest entropy
    estimate over its difference-category histogram (the prediction
    maps are vectorized, so trying all seven costs ~7 image passes).
    """
    if predictor == "auto":
        s = np.asarray(samples)
        dom = (s.astype(np.int64) >> point_transform)
        if dom.ndim == 2:
            dom = dom[:, :, None]
        best, best_bits = 1, None
        for p in range(1, 8):
            d = _interior_diffs(dom, p)
            cats = np.zeros(d.shape, np.int8)
            nz = d != 0
            cats[nz] = np.floor(
                np.log2(np.abs(d[nz]))).astype(np.int8) + 1
            counts = np.bincount(cats.reshape(-1), minlength=18)
            probs = counts / max(counts.sum(), 1)
            nzp = probs > 0
            # code bits ~ -log2(p) per symbol + the magnitude bits
            bits = float(-(counts[nzp] * np.log2(probs[nzp])).sum()
                         + (counts * np.arange(18)).sum())
            if best_bits is None or bits < best_bits:
                best, best_bits = p, bits
        predictor = best
    from jpeg_tpu_torch.entropy.optimize import build_optimal_table

    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[:, :, None]
    H, W, ncomp = s.shape
    if ncomp > 4:
        raise ValueError(f"at most 4 components, got {ncomp}")
    if precision is None:
        precision = 8 if s.dtype == np.uint8 else 16
    if not 2 <= precision <= 16:
        raise ValueError(f"invalid precision {precision}")
    if not 1 <= predictor <= 7:
        raise ValueError(f"invalid predictor {predictor}")
    if not 0 <= point_transform < precision:
        raise ValueError(f"invalid point transform {point_transform}")
    maxval = (1 << precision) - 1
    if int(s.max(initial=0)) > maxval:
        raise ValueError(f"samples exceed {precision}-bit range")
    pt = point_transform
    dom = (s.astype(np.int64) >> pt).astype(np.int32)
    default = 1 << (precision - pt - 1)

    n = H * W
    ri = restart_interval or n
    seg_starts = list(range(0, n, ri))

    diffs = prediction_differences(dom, predictor, default, restart_interval)

    # Categories: value 32768 -> SSSS 16 (no bits); else signed in
    # [-32767, 32767] with the standard magnitude coding.
    signed = np.where(diffs >= 32768, diffs - 65536, diffs)
    ssss = np.zeros_like(diffs)
    nz = signed != 0
    ssss[nz] = np.floor(np.log2(np.abs(signed[nz]))).astype(np.int32) + 1
    ssss[diffs == 32768] = 16

    tables = []
    maps = []
    for ci in range(ncomp):
        freq = np.zeros(256, np.int64)
        cats, counts = np.unique(ssss[:, ci], return_counts=True)
        freq[cats] = counts
        t = build_optimal_table(freq)
        tables.append(t)
        code = np.zeros(256, np.uint32)
        length = np.zeros(256, np.uint8)
        code[t.values] = t.codes.astype(np.uint32)
        length[t.values] = t.lengths
        maps.append((code, length))

    # Vectorized symbol assembly: per sample-component, one fused field
    # (huffman code ++ magnitude bits, <= 32 bits) packed by
    # :func:`_pack_bits`; per-segment byte padding + 0xFF00 stuffing.
    fused_vals = np.zeros((n, ncomp), np.uint64)
    fused_lens = np.zeros((n, ncomp), np.int64)
    for ci in range(ncomp):
        code, length = maps[ci]
        cat = ssss[:, ci]
        clen = length[cat].astype(np.int64)
        cval = code[cat].astype(np.uint64)
        extra = np.where((cat > 0) & (cat < 16), cat, 0).astype(np.int64)
        v = signed[:, ci].astype(np.int64)
        raw = np.where(v >= 0, v, v + (1 << cat.astype(np.int64)) - 1)
        raw = (raw & ((1 << extra) - 1)).astype(np.uint64)
        fused_vals[:, ci] = (cval << extra.astype(np.uint64)) | raw
        fused_lens[:, ci] = clen + extra
    fused_vals = fused_vals.reshape(-1)
    fused_lens = fused_lens.reshape(-1)
    scan = bytearray()
    for k, s0 in enumerate(seg_starts):
        if k:
            scan += bytes([0xFF, 0xD0 + ((k - 1) % 8)])  # RSTn
        e0, e1 = s0 * ncomp, min(s0 + ri, n) * ncomp
        scan += _pack_bits(fused_vals[e0:e1], fused_lens[e0:e1])

    # Container: SOI + SOF3 + per-component DHT + (DRI) + SOS + EOI.
    out = bytearray(b"\xff\xd8")
    sof = bytes([precision]) + H.to_bytes(2, "big") + W.to_bytes(2, "big")
    sof += bytes([ncomp])
    for ci in range(ncomp):
        sof += bytes([ci + 1, 0x11, 0])  # 1x1 sampling, Tq ignored
    out += b"\xff\xc3" + (len(sof) + 2).to_bytes(2, "big") + sof
    for ci, t in enumerate(tables):
        body = bytes([ci]) + bytes(t.bits.tolist()) + bytes(
            t.values.tolist())
        out += b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big") + body
    if restart_interval:
        out += b"\xff\xdd\x00\x04" + restart_interval.to_bytes(2, "big")
    sos = bytes([ncomp])
    for ci in range(ncomp):
        sos += bytes([ci + 1, ci << 4])
    sos += bytes([predictor, 0, pt])  # Ss = predictor, Se = 0, AhAl = Pt
    out += b"\xff\xda" + (len(sos) + 2).to_bytes(2, "big") + sos
    out += scan
    out += b"\xff\xd9"
    return bytes(out)
