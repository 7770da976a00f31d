"""Arithmetic-coded JPEG entropy layer (ITU T.81 Annexes D/E/F).

Beyond the reference (which supports Huffman baseline only): the QM coder
with the adaptive binary states of Table D.3 and the sequential DC/AC
statistical models of F.1.4.4. Streams are produced by SOF9 frames with a
DAC conditioning segment; libjpeg-turbo encodes and decodes them, which is
the independent ground truth for the tests (tools/jpeg_arith_ref.c dumps
its coefficient output).

Decoder register semantics were verified instruction-by-instruction against
the system libjpeg's QM core: C holds the code bytes (two preloaded at
init), A the interval in [0x8000, 0x10000] (0x10000 at init), CT the shift
count for the lazy renormalization (``threshold = A << CT``); byte-in
swallows 0xFF runs, keeps 0xFF for a stuffed zero, and supplies zeros once
a real marker (or the segment end) is reached.

Copy of ``jpeg_tpu/entropy/arith.py``, whole: the port's decoder runs its
two decoders with ``engine="oracle"``; its encoders write the port's SOF9
streams with ``engine="python"`` and ``encode_cmyk(arithmetic=True)``, and
every SOF10 stream (``encode_rgb_progressive(arithmetic=True)``).
"""

from __future__ import annotations

import numpy as np

from jpeg_tpu_torch.io.container import DecodePlan, JPEGError

# T.81 Table D.3: (Qe, NMPS, NLPS, SWITCH) x 113 adaptive states + the
# non-adapting ~0.5 "fixed bin" at index 113 (used for AC sign decisions).
QE_TABLE = (
    (0x5A1D, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0), (0x080B, 4, 18, 0),
    (0x03D8, 5, 20, 0), (0x01DA, 6, 23, 0), (0x00E5, 7, 25, 0), (0x006F, 8, 28, 0),
    (0x0036, 9, 30, 0), (0x001A, 10, 33, 0), (0x000D, 11, 35, 0), (0x0006, 12, 9, 0),
    (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5A7F, 15, 15, 1), (0x3F25, 16, 36, 0),
    (0x2CF2, 17, 38, 0), (0x207C, 18, 39, 0), (0x17B9, 19, 40, 0), (0x1182, 20, 42, 0),
    (0x0CEF, 21, 43, 0), (0x09A1, 22, 45, 0), (0x072F, 23, 46, 0), (0x055C, 24, 48, 0),
    (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0), (0x01B1, 28, 54, 0),
    (0x0144, 29, 56, 0), (0x00F5, 30, 57, 0), (0x00B7, 31, 59, 0), (0x008A, 32, 60, 0),
    (0x0068, 33, 62, 0), (0x004E, 34, 63, 0), (0x003B, 35, 32, 0), (0x002C, 9, 33, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 38, 64, 0), (0x3A0D, 39, 65, 0), (0x2EF1, 40, 67, 0),
    (0x261F, 41, 68, 0), (0x1F33, 42, 69, 0), (0x19A8, 43, 70, 0), (0x1518, 44, 72, 0),
    (0x1177, 45, 73, 0), (0x0E74, 46, 74, 0), (0x0BFB, 47, 75, 0), (0x09F8, 48, 77, 0),
    (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05CD, 51, 48, 0), (0x04DE, 52, 50, 0),
    (0x040F, 53, 50, 0), (0x0363, 54, 51, 0), (0x02D4, 55, 52, 0), (0x025C, 56, 53, 0),
    (0x01F8, 57, 54, 0), (0x01A4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
    (0x00F6, 61, 58, 0), (0x00CB, 62, 59, 0), (0x00AB, 63, 61, 0), (0x008F, 32, 61, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 66, 80, 0), (0x412C, 67, 81, 0), (0x37D8, 68, 82, 0),
    (0x2FE8, 69, 83, 0), (0x293C, 70, 84, 0), (0x2379, 71, 86, 0), (0x1EDF, 72, 87, 0),
    (0x1AA9, 73, 87, 0), (0x174E, 74, 72, 0), (0x1424, 75, 72, 0), (0x119C, 76, 74, 0),
    (0x0F6B, 77, 74, 0), (0x0D51, 78, 75, 0), (0x0BB6, 79, 77, 0), (0x0A40, 48, 77, 0),
    (0x5832, 81, 80, 1), (0x4D1C, 82, 88, 0), (0x438E, 83, 89, 0), (0x3BDD, 84, 90, 0),
    (0x34EE, 85, 91, 0), (0x2EAE, 86, 92, 0), (0x299A, 87, 93, 0), (0x2516, 71, 86, 0),
    (0x5570, 89, 88, 1), (0x4CA9, 90, 95, 0), (0x44D9, 91, 96, 0), (0x3E22, 92, 97, 0),
    (0x3824, 93, 99, 0), (0x32B4, 94, 99, 0), (0x2E17, 86, 93, 0), (0x56A8, 96, 95, 1),
    (0x4F46, 97, 101, 0), (0x47E5, 98, 102, 0), (0x41CF, 99, 103, 0), (0x3C3D, 100, 104, 0),
    (0x375E, 93, 99, 0), (0x5231, 102, 105, 0), (0x4C0F, 103, 106, 0), (0x4639, 104, 107, 0),
    (0x415E, 99, 103, 0), (0x5627, 106, 105, 1), (0x50E7, 107, 108, 0), (0x4B85, 103, 109, 0),
    (0x5597, 109, 110, 0), (0x504F, 107, 111, 0), (0x5A10, 111, 110, 1), (0x5522, 109, 112, 0),
    (0x59EB, 111, 112, 1), (0x5A1D, 113, 113, 0),
)

FIXED_BIN = 113


class ArithDecoder:
    """QM decoder over one (already unstuffed) entropy-coded segment."""

    def __init__(self, data: np.ndarray):
        self.data = data
        self.pos = 0
        self.n = len(data)
        self.c = 0
        self.a = 0
        self.ct = -16  # forces the two-byte initial fill on first decode

    def _byte_in(self) -> int:
        # Container unstuffing already removed 0xFF00 zeros and cut the
        # segment at real markers, so past-the-end reads supply the zero
        # fill the spec mandates after a marker.
        if self.pos < self.n:
            b = int(self.data[self.pos])
            self.pos += 1
            return b
        return 0

    def decode(self, st: bytearray, i: int) -> int:
        """Decode one binary decision with adaptive state st[i]
        (bit 7 = current MPS, bits 0-6 = Table D.3 index)."""
        a = self.a
        # Lazy renormalization + byte-in (F.2.2.3).
        while a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                self.c = (self.c << 8) | self._byte_in()
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        # Two initial bytes loaded: start the interval.
                        a = 0x10000
                        break
                    continue
            a <<= 1
        sv = st[i]
        qe, nmps, nlps, switch = QE_TABLE[sv & 0x7F]
        a -= qe
        threshold = a << self.ct
        if self.c < threshold:
            if a >= 0x8000:  # fast path: no renorm, no adaptation
                self.a = a
                return sv >> 7
            # MPS renorm path (F.2.2.1 MPS_EXCHANGE)
            self.a = a
            if qe <= a:  # decode MPS, move to NMPS
                st[i] = (sv & 0x80) | nmps
                return sv >> 7
            # conditional exchange: decode LPS
            if switch:
                st[i] = ((sv & 0x80) ^ 0x80) | nlps
            else:
                st[i] = (sv & 0x80) | nlps
            return (sv >> 7) ^ 1
        # Upper region (F.2.2.2 LPS_EXCHANGE)
        self.c -= threshold
        self.a = qe
        if qe > a:  # conditional exchange: decode MPS, move to NMPS
            st[i] = (sv & 0x80) | nmps
            return sv >> 7
        if switch:
            st[i] = ((sv & 0x80) ^ 0x80) | nlps
        else:
            st[i] = (sv & 0x80) | nlps
        return (sv >> 7) ^ 1


def _decode_dc(dec, st_dc, ctx, last_dc, ci, L, U):
    """One DC difference (F.1.4.4.1); updates ctx[ci] and last_dc[ci]."""
    base = ctx[ci]
    if dec.decode(st_dc, base) == 0:
        ctx[ci] = 0
        return
    sign = dec.decode(st_dc, base + 1)
    i = base + 2 + sign
    if dec.decode(st_dc, i) == 0:
        m = 0
    else:
        m = 1
        i = 20  # X1 (Table F.4)
        while dec.decode(st_dc, i):
            m <<= 1
            if m == 0x8000:
                raise JPEGError("corrupt arithmetic DC magnitude")
            i += 1
    # Conditioning category for the NEXT block (F.1.4.4.1.2).
    if m < (1 << L) >> 1:
        ctx[ci] = 0
    elif m > (1 << U) >> 1:
        ctx[ci] = 12 + sign * 4
    else:
        ctx[ci] = 4 + sign * 4
    v = m
    i += 14  # the magnitude-bit state sits 14 past the width state
    while m > 1:
        m >>= 1
        if dec.decode(st_dc, i):
            v |= m
    v += 1
    if sign:
        v = -v
    last_dc[ci] += v


def _decode_ac(dec, st_ac, st_fixed, block, kx):
    """AC coefficients of one block into zigzag positions 1..63
    (F.1.4.4.2)."""
    k = 1
    while k <= 63:
        st = 3 * (k - 1)
        if dec.decode(st_ac, st):  # end-of-block decision
            return
        while dec.decode(st_ac, st + 1) == 0:
            st += 3
            k += 1
            if k > 63:
                raise JPEGError("corrupt arithmetic AC run")
        sign = dec.decode(st_fixed, 0)
        st += 2
        if dec.decode(st_ac, st) == 0:
            m = 0
        elif dec.decode(st_ac, st) == 0:
            m = 1
        else:
            m = 2
            st = 189 if k <= kx else 217
            while dec.decode(st_ac, st):
                m <<= 1
                if m == 0x8000:
                    raise JPEGError("corrupt arithmetic AC magnitude")
                st += 1
        v = m
        st += 14
        while m > 1:
            m >>= 1
            if dec.decode(st_ac, st):
                v |= m
        v += 1
        if sign:
            v = -v
        block[k] = v
        k += 1


def decode_coefficients_arith(plan: DecodePlan) -> np.ndarray:
    """Sequential arithmetic scan -> [total_blocks, 64] int32, zigzag order,
    DC prediction applied, MCU stream order — the same entropy-layer
    contract as :func:`jpeg_tpu_torch.entropy.oracle.decode_coefficients`.

    Restart markers re-initialize the coder AND reset every statistics
    area, conditioning context, and DC predictor (F.2.1.3.1)."""
    if not plan.arith_code:
        raise JPEGError("not an arithmetic-coded plan")
    slots = plan.component_block_slots()
    bpm = plan.blocks_per_mcu
    out = np.zeros((plan.total_blocks, 64), np.int32)
    ncomp = len(plan.components)
    for seg in plan.segments:
        dec = ArithDecoder(plan.scan_data[seg.byte_start:seg.byte_end])
        dc_stats = [bytearray(64) for _ in range(4)]
        ac_stats = [bytearray(256) for _ in range(4)]
        fixed = bytearray([FIXED_BIN])
        ctx = [0] * ncomp
        last_dc = [0] * ncomp
        row = seg.mcu_start * bpm
        for _ in range(seg.mcu_count):
            for ci, _sub in slots:
                c = plan.components[ci]
                L, U = plan.arith_dc_L[c.dc_id], plan.arith_dc_U[c.dc_id]
                _decode_dc(dec, dc_stats[c.dc_id], ctx, last_dc, ci, L, U)
                block = out[row]
                block[0] = last_dc[ci]
                _decode_ac(dec, ac_stats[c.ac_id], fixed, block,
                           plan.arith_ac_K[c.ac_id])
                row += 1
    return out


class ArithEncoder:
    """QM encoder (T.81 Annex D, F.1.4) — the exact dual of
    :class:`ArithDecoder`, including the stacked-0xFF carry resolution and
    the trailing-zero-dropping flush. Output is the stuffed entropy byte
    stream (0xFF 0x00 pairs included)."""

    def __init__(self):
        self.c = 0
        self.a = 0x10000
        self.sc = 0  # stacked 0xFF bytes awaiting carry resolution
        self.zc = 0  # pending zero bytes
        self.ct = 11
        self.buffer = -1  # last pending output byte (-1: none yet)
        self.out = bytearray()

    def _flush_zc(self):
        if self.zc:
            self.out.extend(b"\x00" * self.zc)
            self.zc = 0

    def encode(self, st: bytearray, i: int, bit: int) -> None:
        sv = st[i]
        qe, nmps, nlps, switch = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if bit != (sv >> 7):
            # LPS path (F.1.4.3.1 CODELPS with conditional exchange)
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            if switch:
                st[i] = ((sv & 0x80) ^ 0x80) | nlps
            else:
                st[i] = (sv & 0x80) | nlps
        else:
            # MPS path
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) | nmps
        while True:  # renormalization + byte output (F.1.4.3.2)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    # Carry propagates into the pending byte; stacked 0xFFs
                    # roll over to zeros.
                    if self.buffer >= 0:
                        self._flush_zc()
                        self.out.append(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self.out.append(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1  # defer: may still receive a carry
                else:
                    if self.buffer == 0:
                        self.zc += 1  # defer zeros (dropped if trailing)
                    elif self.buffer > 0:
                        self._flush_zc()
                        self.out.append(self.buffer)
                    if self.sc:
                        self._flush_zc()
                        self.out.extend(b"\xff\x00" * self.sc)
                        self.sc = 0
                    self.buffer = temp
                self.c &= 0x7FFFF
                self.ct = 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        """D.1.8 termination: pick the code point with the most trailing
        zeros, flush pending bytes, drop trailing zeros."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zc()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer > 0:
                self._flush_zc()
                self.out.append(self.buffer)
            if self.sc:
                self._flush_zc()
                self.out.extend(b"\xff\x00" * self.sc)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zc()
            b = (self.c >> 19) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self.out.append(b)
                if b == 0xFF:
                    self.out.append(0)
        return bytes(self.out)


def _encode_dc(enc, st_dc, ctx, last_dc, ci, L, U, dc_val):
    diff = dc_val - last_dc[ci]
    last_dc[ci] = dc_val
    base = ctx[ci]
    if diff == 0:
        enc.encode(st_dc, base, 0)
        ctx[ci] = 0
        return
    enc.encode(st_dc, base, 1)
    sign = 1 if diff < 0 else 0
    enc.encode(st_dc, base + 1, sign)
    v = -diff if sign else diff
    v -= 1
    i = base + 2 + sign
    if v == 0:
        enc.encode(st_dc, i, 0)
        m = 0
    else:
        enc.encode(st_dc, i, 1)
        m = 1
        i = 20
        while (m << 1) <= v:
            enc.encode(st_dc, i, 1)
            m <<= 1
            i += 1
        enc.encode(st_dc, i, 0)
    if m < (1 << L) >> 1:
        ctx[ci] = 0
    elif m > (1 << U) >> 1:
        ctx[ci] = 12 + sign * 4
    else:
        ctx[ci] = 4 + sign * 4
    i += 14
    mm = m >> 1
    while mm:
        enc.encode(st_dc, i, 1 if v & mm else 0)
        mm >>= 1


def _encode_ac(enc, st_ac, st_fixed, block_zz, kx):
    ke = 0
    for k in range(63, 0, -1):
        if block_zz[k]:
            ke = k
            break
    k = 1
    while k <= ke:
        st = 3 * (k - 1)
        enc.encode(st_ac, st, 0)  # not EOB
        while block_zz[k] == 0:
            enc.encode(st_ac, st + 1, 0)
            st += 3
            k += 1
        enc.encode(st_ac, st + 1, 1)
        val = int(block_zz[k])
        sign = 1 if val < 0 else 0
        enc.encode(st_fixed, 0, sign)
        v = (-val if sign else val) - 1
        st += 2
        if v == 0:
            enc.encode(st_ac, st, 0)
            m = 0
        else:
            enc.encode(st_ac, st, 1)
            if v == 1:
                enc.encode(st_ac, st, 0)
                m = 1
            else:
                enc.encode(st_ac, st, 1)
                m = 2
                st = 189 if k <= kx else 217
                while (m << 1) <= v:
                    enc.encode(st_ac, st, 1)
                    m <<= 1
                    st += 1
                enc.encode(st_ac, st, 0)
        st += 14
        mm = m >> 1
        while mm:
            enc.encode(st_ac, st, 1 if v & mm else 0)
            mm >>= 1
        k += 1
    if ke < 63:
        enc.encode(st_ac, 3 * k - 3, 1)  # EOB


def encode_scan_arith(comp_blocks_zz, samplings, mcus_x, mcus_y,
                      restart_interval_mcus, table_ids,
                      dc_L=(0, 0, 0, 0), dc_U=(1, 1, 1, 1),
                      ac_K=(5, 5, 5, 5)) -> bytes:
    """Arithmetic entropy pack of quantized zigzag block grids (same inputs
    as the Huffman packers in models/encoder.py). Restart markers reset the
    coder, every statistics area and the DC state (F.2.1.3.1)."""
    ncomp = len(samplings)
    slots = []
    for ci, (h, v) in enumerate(samplings):
        for vi in range(v):
            for hi in range(h):
                slots.append((ci, vi, hi))
    n_mcus = mcus_x * mcus_y

    def fresh():
        return (ArithEncoder(), [bytearray(64) for _ in range(4)],
                [bytearray(256) for _ in range(4)],
                bytearray([FIXED_BIN]), [0] * ncomp, [0] * ncomp)

    scan = bytearray()
    enc, dc_stats, ac_stats, fixed, ctx, last_dc = fresh()
    rst = 0
    for mi in range(n_mcus):
        if restart_interval_mcus and mi > 0 and mi % restart_interval_mcus == 0:
            scan += enc.finish()
            scan += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) % 8
            enc, dc_stats, ac_stats, fixed, ctx, last_dc = fresh()
        my, mx = divmod(mi, mcus_x)
        for ci, vi, hi in slots:
            h, v = samplings[ci]
            ti = table_ids[ci]
            blk = comp_blocks_zz[ci][my * v + vi, mx * h + hi]
            _encode_dc(enc, dc_stats[ti], ctx, last_dc, ci,
                       dc_L[ti], dc_U[ti], int(blk[0]))
            _encode_ac(enc, ac_stats[ti], fixed, blk, ac_K[ti])
    scan += enc.finish()
    return bytes(scan)


def _comp_block_dims(plan, ci):
    c = plan.components[ci]
    cw = -(-plan.width * c.h // plan.h_max)
    ch = -(-plan.height * c.v // plan.v_max)
    return -(-ch // 8), -(-cw // 8)


def decode_progressive_coefficients_arith(plan: DecodePlan) -> np.ndarray:
    """Progressive arithmetic (SOF10) scans -> [total_blocks, 64] int32,
    zigzag order, MCU stream order — the shared entropy-layer contract.

    Scan semantics per T.81 G.1.3 with the QM coder: DC-first scans use the
    sequential DC model with an Al shift, DC refinements a single fixed-bin
    decision per block, AC-first the sequential AC model (no EOB runs —
    the EOB decision is per block), AC refinements correction bits with the
    per-k statistics. Restart segments reset the coder + statistics."""
    if not (plan.progressive and plan.arith_code):
        raise JPEGError("not a progressive arithmetic plan")
    state = [
        np.zeros((plan.mcus_y * c.v, plan.mcus_x * c.h, 64), np.int32)
        for c in plan.components
    ]
    for scan in plan.prog_scans:
        if scan.ss == 0:
            if scan.se != 0:
                raise JPEGError("progressive DC scan must have se == 0")
            _prog_dc_scan_arith(plan, scan, state)
        else:
            _prog_ac_scan_arith(plan, scan, state)

    out = np.zeros((plan.total_blocks, 64), np.int32)
    slots = plan.component_block_slots()
    bpm = plan.blocks_per_mcu
    my, mx = np.divmod(np.arange(plan.n_mcus), plan.mcus_x)
    for si, (ci, sub) in enumerate(slots):
        c = plan.components[ci]
        vi, hi = divmod(sub, c.h)
        out[si::bpm] = state[ci][my * c.v + vi, mx * c.h + hi]
    return out


def _prog_dc_scan_arith(plan, scan, state):
    interleaved = len(scan.comp_indices) > 1
    ncomp = len(scan.comp_indices)
    if interleaved:
        n_units = plan.n_mcus
    else:
        bh, bw = _comp_block_dims(plan, scan.comp_indices[0])
        n_units = bh * bw
    ri = scan.restart_interval or n_units
    al = scan.al
    unit = 0
    for (s, e) in scan.bounds:
        if unit >= n_units:
            break
        dec = ArithDecoder(scan.scan_data[s:e])
        dc_stats = [bytearray(64) for _ in range(4)]
        fixed = bytearray([FIXED_BIN])
        ctx = [0] * ncomp
        last_dc = [0] * ncomp
        for _ in range(min(ri, n_units - unit)):
            if interleaved:
                my, mx = divmod(unit, plan.mcus_x)
                for si, ci in enumerate(scan.comp_indices):
                    c = plan.components[ci]
                    tid = scan.dc_ids[si]
                    for vi in range(c.v):
                        for hi in range(c.h):
                            blk = state[ci][my * c.v + vi, mx * c.h + hi]
                            _prog_dc_block(dec, dc_stats[tid], fixed, ctx,
                                           last_dc, si, scan, tid, blk, al)
            else:
                ci = scan.comp_indices[0]
                bh, bw = _comp_block_dims(plan, ci)
                by, bx = divmod(unit, bw)
                blk = state[ci][by, bx]
                _prog_dc_block(dec, dc_stats[scan.dc_ids[0]], fixed, ctx,
                               last_dc, 0, scan, scan.dc_ids[0], blk, al)
            unit += 1


def _prog_dc_block(dec, st_dc, fixed, ctx, last_dc, si, scan, tid, blk, al):
    if scan.ah:  # refinement: one fixed-bin bit per block
        if dec.decode(fixed, 0):
            blk[0] |= 1 << al
        return
    L, U = scan.arith_dc_L[tid], scan.arith_dc_U[tid]
    _decode_dc(dec, st_dc, ctx, last_dc, si, L, U)
    blk[0] = last_dc[si] << al


def _prog_ac_scan_arith(plan, scan, state):
    ci = scan.comp_indices[0]
    tid = scan.ac_ids[0]
    kx = scan.arith_ac_K[tid]
    bh, bw = _comp_block_dims(plan, ci)
    n_units = bh * bw
    ri = scan.restart_interval or n_units
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    p1 = 1 << al
    m1 = -p1
    unit = 0
    for (s, e) in scan.bounds:
        if unit >= n_units:
            break
        dec = ArithDecoder(scan.scan_data[s:e])
        ac_stats = bytearray(256)
        fixed = bytearray([FIXED_BIN])
        for _ in range(min(ri, n_units - unit)):
            by, bx = divmod(unit, bw)
            blk = state[ci][by, bx]
            if ah == 0:
                k = ss
                while k <= se:
                    st = 3 * (k - 1)
                    if dec.decode(ac_stats, st):
                        break  # EOB
                    while dec.decode(ac_stats, st + 1) == 0:
                        st += 3
                        k += 1
                        if k > se:
                            raise JPEGError("corrupt progressive AC run")
                    sign = dec.decode(fixed, 0)
                    st += 2
                    if dec.decode(ac_stats, st) == 0:
                        m = 0
                    elif dec.decode(ac_stats, st) == 0:
                        m = 1
                    else:
                        m = 2
                        st = 189 if k <= kx else 217
                        while dec.decode(ac_stats, st):
                            m <<= 1
                            if m == 0x8000:
                                raise JPEGError(
                                    "corrupt progressive AC magnitude")
                            st += 1
                    v = m
                    st += 14
                    while m > 1:
                        m >>= 1
                        if dec.decode(ac_stats, st):
                            v |= m
                    v += 1
                    blk[k] = (-v if sign else v) << al
                    k += 1
            else:
                kex = se
                while kex > 0 and blk[kex] == 0:
                    kex -= 1
                k = ss
                while k <= se:
                    st = 3 * (k - 1)
                    if k > kex and dec.decode(ac_stats, st):
                        break  # EOB
                    while True:
                        c = int(blk[k])
                        if c != 0:
                            if dec.decode(ac_stats, st + 2):
                                blk[k] = c + (m1 if c < 0 else p1)
                            break
                        if dec.decode(ac_stats, st + 1):
                            blk[k] = m1 if dec.decode(fixed, 0) else p1
                            break
                        st += 3
                        k += 1
                        if k > se:
                            raise JPEGError(
                                "corrupt progressive AC refinement")
                    k += 1
            unit += 1


def _enc_ac_value(enc, ac_stats, fixed, st, k, kx, val):
    """Sign + magnitude + bits of one nonzero (scaled) AC value at k,
    with st already at the run-end position (F.1.4.4.2 dual)."""
    sign = 1 if val < 0 else 0
    enc.encode(fixed, 0, sign)
    v = (-val if sign else val) - 1
    st += 2
    if v == 0:
        enc.encode(ac_stats, st, 0)
        m = 0
    else:
        enc.encode(ac_stats, st, 1)
        if v == 1:
            enc.encode(ac_stats, st, 0)
            m = 1
        else:
            enc.encode(ac_stats, st, 1)
            m = 2
            st = 189 if k <= kx else 217
            while (m << 1) <= v:
                enc.encode(ac_stats, st, 1)
                m <<= 1
                st += 1
            enc.encode(ac_stats, st, 0)
    st += 14
    mm = m >> 1
    while mm:
        enc.encode(ac_stats, st, 1 if v & mm else 0)
        mm >>= 1


def encode_progressive_scans_arith(comp_blocks_zz, samplings, mcus_x, mcus_y,
                                   scan_script, restart_interval,
                                   table_ids) -> list:
    """Arithmetic entropy for a progressive scan script -> list of
    {"comps", "ss", "se", "ah", "al", "data"} (data includes RST markers).
    The exact dual of :func:`decode_progressive_coefficients_arith`."""
    ncomp = len(samplings)
    out_scans = []
    for comps, ss, se, ah, al in scan_script:
        if ss == 0:
            data = _enc_prog_dc_scan(comp_blocks_zz, samplings, mcus_x,
                                     mcus_y, comps, ah, al,
                                     restart_interval, table_ids)
        else:
            data = _enc_prog_ac_scan(comp_blocks_zz, samplings, comps[0],
                                     ss, se, ah, al, restart_interval,
                                     table_ids)
        out_scans.append({"comps": list(comps), "ss": ss, "se": se,
                          "ah": ah, "al": al, "data": data, "tables": []})
    return out_scans


def _enc_prog_dc_scan(comp_blocks_zz, samplings, mcus_x, mcus_y, comps,
                      ah, al, restart_interval, table_ids):
    interleaved = len(comps) > 1
    if interleaved:
        n_units = mcus_x * mcus_y
    else:
        bh, bw = comp_blocks_zz[comps[0]].shape[:2]
        n_units = bh * bw
    ri = restart_interval or n_units

    scan = bytearray()
    rst = 0
    unit = 0
    while unit < n_units:
        enc = ArithEncoder()
        dc_stats = [bytearray(64) for _ in range(4)]
        fixed = bytearray([FIXED_BIN])
        ctx = [0] * len(comps)
        last_dc = [0] * len(comps)
        for _ in range(min(ri, n_units - unit)):
            if interleaved:
                my, mx = divmod(unit, mcus_x)
                for si, ci in enumerate(comps):
                    h, v = samplings[ci]
                    tid = table_ids[ci]
                    for vi in range(v):
                        for hi in range(h):
                            blk = comp_blocks_zz[ci][my * v + vi, mx * h + hi]
                            _enc_prog_dc_block(enc, dc_stats[tid], fixed,
                                               ctx, last_dc, si,
                                               int(blk[0]), ah, al)
            else:
                ci = comps[0]
                bh, bw = comp_blocks_zz[ci].shape[:2]
                by, bx = divmod(unit, bw)
                _enc_prog_dc_block(enc, dc_stats[table_ids[ci]], fixed, ctx,
                                   last_dc, 0,
                                   int(comp_blocks_zz[ci][by, bx][0]),
                                   ah, al)
            unit += 1
        scan += enc.finish()
        if unit < n_units:
            scan += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) % 8
    return bytes(scan)


def _enc_prog_dc_block(enc, st_dc, fixed, ctx, last_dc, si, dc, ah, al):
    if ah:  # refinement: one fixed-bin bit
        enc.encode(fixed, 0, (dc >> al) & 1)
        return
    # Point transform: arithmetic shift of the signed DC (G.1.2.1).
    _encode_dc(enc, st_dc, ctx, last_dc, si, 0, 1, dc >> al)


def _enc_prog_ac_scan(comp_blocks_zz, samplings, ci, ss, se, ah, al,
                      restart_interval, table_ids):
    grid = comp_blocks_zz[ci]
    bh, bw = grid.shape[:2]
    n_units = bh * bw
    ri = restart_interval or n_units
    kx = 5
    scan = bytearray()
    rst = 0
    unit = 0
    while unit < n_units:
        enc = ArithEncoder()
        ac_stats = bytearray(256)
        fixed = bytearray([FIXED_BIN])
        for _ in range(min(ri, n_units - unit)):
            by, bx = divmod(unit, bw)
            blk = grid[by, bx]
            if ah == 0:
                _enc_prog_ac_first(enc, ac_stats, fixed, blk, ss, se, al, kx)
            else:
                _enc_prog_ac_refine(enc, ac_stats, fixed, blk, ss, se, al)
            unit += 1
        scan += enc.finish()
        if unit < n_units:
            scan += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) % 8
    return bytes(scan)


def _scaled(v, al):
    return (-((-int(v)) >> al)) if v < 0 else (int(v) >> al)


def _enc_prog_ac_first(enc, ac_stats, fixed, blk, ss, se, al, kx):
    ke = 0
    for k in range(se, ss - 1, -1):
        if _scaled(blk[k], al):
            ke = k
            break
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        enc.encode(ac_stats, st, 0)  # not EOB
        while _scaled(blk[k], al) == 0:
            enc.encode(ac_stats, st + 1, 0)
            st += 3
            k += 1
        enc.encode(ac_stats, st + 1, 1)
        _enc_ac_value(enc, ac_stats, fixed, st, k, kx, _scaled(blk[k], al))
        k += 1
    if ke < se:
        enc.encode(ac_stats, 3 * (k - 1), 1)  # EOB


def _enc_prog_ac_refine(enc, ac_stats, fixed, blk, ss, se, al):
    ke = 0
    for k in range(se, ss - 1, -1):
        if abs(int(blk[k])) >> al:
            ke = k
            break
    kex = 0
    for k in range(se, ss - 1, -1):
        if abs(int(blk[k])) >> (al + 1):
            kex = k
            break
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        if k > kex:
            enc.encode(ac_stats, st, 0)  # not EOB
        while True:
            t = abs(int(blk[k])) >> al
            if t > 1:  # previously nonzero: correction bit
                enc.encode(ac_stats, st + 2, t & 1)
                break
            if t == 1:  # newly nonzero this stage
                enc.encode(ac_stats, st + 1, 1)
                enc.encode(fixed, 0, 1 if blk[k] < 0 else 0)
                break
            enc.encode(ac_stats, st + 1, 0)
            st += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(ac_stats, 3 * (k - 1), 1)  # EOB
