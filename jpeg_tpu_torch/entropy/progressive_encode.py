"""Progressive (SOF2) entropy ENCODE — the mirror of entropy/progressive.py.

Follows libjpeg's jcphuff semantics (DC first/refine, AC first with EOB-run
accumulation, AC refine with buffered correction bits) and its standard scan
script. Each scan uses per-scan optimal Huffman tables (a counting pass
feeds :func:`jpeg_tpu_torch.entropy.optimize.build_optimal_table`, then an emit
pass packs bits) — progressive symbol distributions differ too much from the
Annex K typical tables for those to be usable.

Validation contract (tests): our progressive encode decodes to EXACTLY the
same pixels as our baseline encode of the same image (identical quantized
coefficients), and libjpeg/PIL decodes our streams.

Copy of ``jpeg_tpu/entropy/progressive_encode.py``, held to it by the
port's tests; the C++ twin is ``runtime.native_encode_progressive_scans``.
"""

from __future__ import annotations

import numpy as np

from jpeg_tpu_torch.entropy.optimize import build_optimal_table


def standard_scan_script(ncomp: int) -> list[tuple]:
    """libjpeg's standard progressive script: (comps, ss, se, ah, al)."""
    if ncomp == 1:
        return [
            ((0,), 0, 0, 0, 1),
            ((0,), 1, 5, 0, 2),
            ((0,), 6, 63, 0, 2),
            ((0,), 1, 63, 2, 1),
            ((0,), 0, 0, 1, 0),
            ((0,), 1, 63, 1, 0),
        ]
    return [
        ((0, 1, 2), 0, 0, 0, 1),
        ((0,), 1, 5, 0, 2),
        ((1,), 1, 63, 0, 1),
        ((2,), 1, 63, 0, 1),
        ((0,), 6, 63, 0, 2),
        ((0,), 1, 63, 2, 1),
        ((0, 1, 2), 0, 0, 1, 0),
        ((1,), 1, 63, 1, 0),
        ((2,), 1, 63, 1, 0),
        ((0,), 1, 63, 1, 0),
    ]


def _nbits(v: int) -> int:
    return int(v).bit_length()


class _CountEmitter:
    """Statistics pass: counts Huffman symbols, swallows raw bits."""

    def __init__(self):
        self.freq = np.zeros(256, dtype=np.int64)

    def symbol(self, sym: int) -> None:
        self.freq[sym] += 1

    def bits(self, value: int, n: int) -> None:
        pass

    def flush(self) -> None:
        pass


class _BitEmitter:
    """Emit pass: Huffman codes + raw bits with 0xFF00 stuffing."""

    def __init__(self, table):
        code = np.zeros(256, dtype=np.uint32)
        length = np.zeros(256, dtype=np.uint8)
        code[table.values] = table.codes.astype(np.uint32)
        length[table.values] = table.lengths
        self.code, self.length = code, length
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def symbol(self, sym: int) -> None:
        self.bits(int(self.code[sym]), int(self.length[sym]))

    def bits(self, value: int, n: int) -> None:
        if n == 0:
            return
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            b = (self.acc >> self.nbits) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)
        self.acc &= (1 << self.nbits) - 1

    def flush(self) -> None:
        if self.nbits:
            pad = 8 - self.nbits
            self.bits((1 << pad) - 1, pad)


def _dc_scan(emitters, blocks_iter, ah, al):
    """DC scan over (comp_slot, coef0) pairs in unit order."""
    if ah == 0:
        pred = {}
        for si, dc in blocks_iter():
            v = int(dc) >> al  # arithmetic shift (libjpeg IRIGHT_SHIFT)
            diff = v - pred.get(si, 0)
            pred[si] = v
            mag = diff if diff >= 0 else -diff
            s = _nbits(mag)
            emitters[si].symbol(s)
            if s:
                emitters[si].bits(diff if diff >= 0 else diff + (1 << s) - 1, s)
    else:
        for si, dc in blocks_iter():
            emitters[si].bits((int(dc) >> al) & 1, 1)


def _ac_first_scan(emit, blocks, ss, se, al):
    """AC first pass with EOB-run accumulation (jcphuff encode_mcu_AC_first)."""
    eobrun = 0

    def emit_eobrun():
        nonlocal eobrun
        if eobrun > 0:
            n = _nbits(eobrun) - 1
            emit.symbol(n << 4)
            if n:
                emit.bits(eobrun & ((1 << n) - 1), n)
            eobrun = 0

    for coef in blocks:
        r = 0
        for k in range(ss, se + 1):
            t = int(coef[k])
            if t < 0:
                temp = (-t) >> al
                temp2 = ~temp
            else:
                temp = t >> al
                temp2 = temp
            if temp == 0:
                r += 1
                continue
            emit_eobrun()
            while r > 15:
                emit.symbol(0xF0)
                r -= 16
            s = _nbits(temp)
            emit.symbol((r << 4) + s)
            emit.bits(temp2 & ((1 << s) - 1), s)
            r = 0
        if r > 0:
            eobrun += 1
            if eobrun == 0x7FFF:
                emit_eobrun()
    emit_eobrun()


def _ac_refine_scan(emit, blocks, ss, se, al):
    """AC refinement pass (jcphuff encode_mcu_AC_refine)."""
    eobrun = 0
    pending: list[int] = []  # correction bits held across EOB runs

    def emit_eobrun():
        nonlocal eobrun, pending
        if eobrun > 0:
            n = _nbits(eobrun) - 1
            emit.symbol(n << 4)
            if n:
                emit.bits(eobrun & ((1 << n) - 1), n)
            for b in pending:
                emit.bits(b, 1)
            pending = []
            eobrun = 0

    for coef in blocks:
        absvals = np.zeros(se + 1, dtype=np.int64)
        eob = ss - 1
        for k in range(ss, se + 1):
            t = int(coef[k])
            a = (-t if t < 0 else t) >> al
            absvals[k] = a
            if a == 1:
                eob = k
        r = 0
        br: list[int] = []
        for k in range(ss, se + 1):
            temp = int(absvals[k])
            if temp == 0:
                r += 1
                continue
            while r > 15 and k <= eob:
                emit_eobrun()
                emit.symbol(0xF0)
                r -= 16
                for b in br:
                    emit.bits(b, 1)
                br = []
            if temp > 1:
                br.append(temp & 1)
                continue
            emit_eobrun()
            emit.symbol((r << 4) + 1)
            r = 0
            emit.bits(0 if int(coef[k]) < 0 else 1, 1)
            for b in br:
                emit.bits(b, 1)
            br = []
        if r > 0 or br:
            eobrun += 1
            pending.extend(br)
            if eobrun == 0x7FFF:
                emit_eobrun()
    emit_eobrun()


def encode_progressive_scans(comp_blocks_zz, samplings, mcus_x, mcus_y,
                             width, height, scan_script=None,
                             restart_interval=0):
    """Quantized zigzag blocks -> list of scan dicts (header fields, tables,
    entropy bytes). ``scan_script``: list of (comps, ss, se, ah, al); default
    is libjpeg's standard script. Successive-approximation scans must step
    al by exactly 1 with matching ah (validated). ``restart_interval`` (in
    scan units: MCUs for interleaved DC scans, blocks otherwise) splits each
    scan into independently-decodable restart segments; scan["data"] then
    contains the RSTn markers."""
    ncomp = len(samplings)
    h_max = max(h for h, _ in samplings)
    v_max = max(v for _, v in samplings)

    def comp_block_dims(ci):
        h, v = samplings[ci]
        cw = -(-width * h // h_max)
        ch = -(-height * v // v_max)
        return -(-ch // 8), -(-cw // 8)

    def dc_units(comps, u0, u1):
        """Yield (slot_index, dc_value) for DC-scan units [u0, u1)."""
        if len(comps) > 1:
            def it():
                for u in range(u0, u1):
                    my, mx = divmod(u, mcus_x)
                    for si, ci in enumerate(comps):
                        h, v = samplings[ci]
                        for vi in range(v):
                            for hi in range(h):
                                yield si, comp_blocks_zz[ci][
                                    my * v + vi, mx * h + hi, 0]
            return it
        ci = comps[0]
        bh, bw = comp_block_dims(ci)

        def it():
            for u in range(u0, u1):
                by, bx = divmod(u, bw)
                yield 0, comp_blocks_zz[ci][by, bx, 0]
        return it

    def ac_blocks(ci, u0, u1):
        bh, bw = comp_block_dims(ci)
        for u in range(u0, u1):
            by, bx = divmod(u, bw)
            yield comp_blocks_zz[ci][by, bx]

    def segment_slices(n_units):
        ri = restart_interval or n_units
        return [(u, min(u + ri, n_units)) for u in range(0, n_units, ri)]

    def join_segments(chunks):
        out = bytearray(chunks[0])
        for i, c in enumerate(chunks[1:]):
            out += bytes([0xFF, 0xD0 + (i % 8)])
            out += c
        return bytes(out)

    scans = []
    script = scan_script or standard_scan_script(ncomp)
    for comps, ss, se, ah, al in script:
        if ah and ah != al + 1:
            raise ValueError(
                f"refinement scan must step al by 1 (ah={ah}, al={al})")
        if ss == 0:
            interleaved = len(comps) > 1
            n_units = (mcus_x * mcus_y if interleaved
                       else int(np.prod(comp_block_dims(comps[0]))))
            segs = segment_slices(n_units)
            # One DC table per scan component (luma=slot of its index).
            counters = [_CountEmitter() for _ in comps]
            for u0, u1 in segs:
                _dc_scan(counters, dc_units(comps, u0, u1), ah, al)
            if ah == 0:
                tables = [build_optimal_table(c.freq) for c in counters]
            else:
                tables = [None] * len(comps)  # refinement: raw bits only
            chunks = []
            for u0, u1 in segs:
                ems = [
                    _BitEmitter(t) if t is not None else _BitEmitter_raw()
                    for t in tables
                ]
                shared = _SharedEmitter(ems)
                _dc_scan(shared.views(), dc_units(comps, u0, u1), ah, al)
                shared.flush()
                chunks.append(shared.data())
            scans.append(dict(comps=comps, ss=ss, se=se, ah=ah, al=al,
                              tables=[("dc", si, t) for si, t in
                                      enumerate(tables) if t is not None],
                              data=join_segments(chunks)))
        else:
            ci = comps[0]
            n_units = int(np.prod(comp_block_dims(ci)))
            segs = segment_slices(n_units)
            counter = _CountEmitter()
            ac_fn = _ac_first_scan if ah == 0 else _ac_refine_scan
            for u0, u1 in segs:
                ac_fn(counter, ac_blocks(ci, u0, u1), ss, se, al)
            table = build_optimal_table(counter.freq)
            chunks = []
            for u0, u1 in segs:
                emit = _BitEmitter(table)
                ac_fn(emit, ac_blocks(ci, u0, u1), ss, se, al)
                emit.flush()
                chunks.append(bytes(emit.out))
            scans.append(dict(comps=comps, ss=ss, se=se, ah=ah, al=al,
                              tables=[("ac", 0, table)],
                              data=join_segments(chunks)))
    return scans


class _BitEmitter_raw(_BitEmitter):
    """Refinement DC scans have no Huffman symbols, only raw bits."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def symbol(self, sym: int) -> None:  # pragma: no cover
        raise AssertionError("refinement scan emits no symbols")


class _SharedEmitter:
    """DC scans interleave components into ONE bit stream; each component
    keeps its own Huffman table but all bits land in a shared accumulator."""

    class _View:
        def __init__(self, base, em):
            self._base = base
            self._em = em

        def symbol(self, sym):
            self._base.bits(int(self._em.code[sym]), int(self._em.length[sym]))

        def bits(self, v, n):
            self._base.bits(v, n)

    def __init__(self, emitters):
        self._base = emitters[0]

        self._views = [
            self._View(self._base, e) if hasattr(e, "code") else self._base
            for e in emitters
        ]

    def views(self):
        return self._views

    def flush(self):
        self._base.flush()

    def data(self):
        return bytes(self._base.out)
