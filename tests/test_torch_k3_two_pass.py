"""K3's two-pass design rehearsed on the CPU, where its CUDA kernel cannot
run.

(a) The host-built skip table, against the plain twin's own symbol
resolution (``_resolve`` + ``_magnitude``) on every 11-bit peek of every
table row in use, codes longer than 11 bits included.

(b) A NumPy model of the kernel's split, held to ``decode_lanes_plain`` row
for row and on ``err``: pass 1 walks each lane through the pair table, one
or two symbols a step, and records, per block, its start bit and the DC
predictor after it; pass 2 decodes each block on its own from its start bit
through the skip table. The model reads the same tables and follows the
same rules as ``csrc/huffman_lanes.cu``; the pair table is also held to two
lookups of the skip table on every peek.
"""

import copy
import os

import numpy as np
import pytest
import torch

from jpeg_tpu_torch import encode_rgb
from jpeg_tpu_torch.entropy.device_huffman import (
    T11,
    _magnitude,
    _resolve,
    decode_lanes_plain,
    lane_tables,
    lane_tensors,
    pair_entries,
    prepare_lane_batch,
    skip_entries,
)
from jpeg_tpu_torch.io.container import parse_jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens", "torch")
RST = ["synth_512x384_s2_q85_rst1.jpg", "synth_512x384_s4_q85_rst1_gray.jpg"]
TABLE_SOURCES = RST + ["synth_512x384_s3_q85_rst0.jpg",
                       "synth_3840x2160_s0_q85_rst1.jpg", "optimize"]


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _optimized_plan():
    """A stream with optimised tables, whose AC codes reach >= 12 bits."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (80, 80, 3), dtype=np.uint8)
    return parse_jpeg(encode_rgb(img, quality=92, subsampling=(2, 2),
                                 restart_interval_mcus=5, optimize=True))


def _plan(source):
    return _optimized_plan() if source == "optimize" else parse_jpeg(_read(source))


def _fields(e):
    """(bits consumed, code length, magnitude bits, advance) of entries."""
    return e & 0x3F, (e >> 8) & 0x1F, (e >> 16) & 0x1F, e >> 24


def _entry_magnitude(peek, e):
    """The kernel's magnitude: the entry's magnitude bits after its code."""
    _, length, nbits, _ = _fields(e)
    raw = (peek >> np.maximum(32 - length - nbits, 0)) & ((1 << nbits) - 1)
    base = np.where(nbits > 0, 1 << np.maximum(nbits - 1, 0), 0)
    return np.where(nbits > 0, np.where(raw < base, raw - 2 * base + 1, raw), 0)


# --------------------------------------------------------------------------
# (a) the skip table


@pytest.mark.parametrize("source", TABLE_SOURCES)
def test_skip_table_agrees_with_resolve(source):
    plan = _plan(source)
    batch = prepare_lane_batch([plan])
    lut, hv, canon = lane_tables(plan)
    rng = np.random.default_rng(len(source))
    peek = ((np.arange(T11, dtype=np.int64) << 21)
            | rng.integers(0, 1 << 21, T11))
    long_codes = 0
    for (_, dc_id, ac_id), (_, kd, ka) in zip(batch.slots, batch.skip_slots):
        for row, krow, dc in ((dc_id, kd, True), (4 + ac_id, ka, False)):
            ln, sym = (x.numpy() for x in _resolve(
                torch.from_numpy(lut[row]).long(), torch.from_numpy(hv[row]).long(),
                canon[row].tolist(), torch.from_numpy(peek)))
            eob, zrl = sym == 0x00, sym == 0xF0
            nbits = sym if dc else np.where(eob | zrl, 0, sym & 0xF)
            want_mag = _magnitude(torch.from_numpy(peek), torch.from_numpy(ln),
                                  torch.from_numpy(nbits)).numpy()
            e = batch.skip[krow].astype(np.int64)
            short = (ln > 0) & (ln <= 11)
            # An entry exactly where the code has at most 11 bits; longer
            # codes get the kernel's make_entry after the canonical walk.
            np.testing.assert_array_equal(e != 0, short)
            np.testing.assert_array_equal(batch.skip_hv[krow], hv[row])
            np.testing.assert_array_equal(batch.skip_canon[krow], canon[row])
            e = np.where(short, e, np.where(ln > 0, skip_entries(ln, sym, dc), 0))
            long_codes += int((ln > 11).sum())
            ok = ln > 0
            used, length, size, adv = _fields(e)
            np.testing.assert_array_equal(length[ok], ln[ok])
            np.testing.assert_array_equal(size[ok], nbits[ok])
            np.testing.assert_array_equal(used[ok], (ln + nbits)[ok])
            np.testing.assert_array_equal(_entry_magnitude(peek, e)[ok],
                                          want_mag[ok])
            if dc:
                assert (adv[ok] == 1).all()
                continue
            # The advance reproduces the plain twin's coefficient index.
            for coef in range(1, 64):
                pos = coef + np.minimum((sym >> 4) & 0xF, 63 - coef)
                nxt = np.where(eob, 64, np.where(zrl, min(coef + 16, 64), pos + 1))
                np.testing.assert_array_equal(
                    np.minimum(coef + adv, 64)[ok], nxt[ok])
                write = ok & ~eob & ~zrl
                np.testing.assert_array_equal(
                    np.minimum(coef + adv - 1, 63)[write], pos[write])
    if source == "optimize":
        assert long_codes > 0  # the canonical walk is exercised


@pytest.mark.parametrize("source", TABLE_SOURCES)
def test_pair_table_is_two_skip_lookups(source):
    """Pass 1's table gives each code's bits and advance (and a DC code's
    length) as the skip table does, and pairs an AC code with the next one
    exactly when the first is not EOB and both, magnitudes included, lie
    within the 11-bit peek."""
    batch = prepare_lane_batch([_plan(source)])
    dc_rows = {int(d) for _, d, _ in batch.skip_slots}
    peeks = np.arange(T11)
    pairs = 0
    for row in range(len(batch.skip)):
        skip = batch.skip[row].astype(np.int64)
        pair = batch.pair[row].astype(np.int64)
        np.testing.assert_array_equal(pair != 0, skip != 0)
        used, length, _, adv = _fields(skip)
        np.testing.assert_array_equal(pair & 0x3F, used)
        np.testing.assert_array_equal((pair >> 6) & 0x7F, np.where(skip != 0, adv, 0))
        if row in dc_rows:
            np.testing.assert_array_equal(pair >> 27, length)
            assert not ((pair >> 26) & 1).any()
            continue
        second = skip[(peeks << np.minimum(used, 11)) & (T11 - 1)]
        want = ((skip != 0) & (adv != 64) & (second != 0)
                & (used + (second & 0x3F) <= 11))
        two = (pair >> 26) & 1 == 1
        np.testing.assert_array_equal(two, want)
        np.testing.assert_array_equal(((pair >> 13) & 0x3F)[two],
                                      (used + (second & 0x3F))[two])
        np.testing.assert_array_equal(((pair >> 19) & 0x7F)[two],
                                      (adv + (second >> 24))[two])
        pairs += int(two.sum())
    assert pairs > 0


# --------------------------------------------------------------------------
# (b) the two-pass split


class _Model:
    """The kernel's two passes over a LaneBatch, one symbol at a time."""

    def __init__(self, batch):
        self.b = batch
        self.data = bytes(batch.data)
        self.skip = batch.skip.tolist()
        self.pair = batch.pair.tolist()
        self.hv = batch.skip_hv.tolist()
        self.canon = batch.skip_canon.tolist()
        self.slots = batch.skip_slots.tolist()

    def peek(self, lane, bit):
        """32 bits of a lane's stream at ``bit``, 0xAA past its end."""
        start, length = int(self.b.lane_start[lane]), int(self.b.lane_len[lane])
        acc = 0
        for j in range(5):
            q = (bit >> 3) + j
            acc = (acc << 8) | (self.data[start + q] if q < length else 0xAA)
        return (acc >> (8 - (bit & 7))) & 0xFFFFFFFF

    def entry(self, row, peek, dc, table="skip"):
        """The entry of ``table`` ("skip", pass 2's, or "pair", pass 1's)
        for the code at the top of ``peek``; 0 for an invalid prefix."""
        e = getattr(self, table)[row][peek >> 21]
        if e:
            return e
        cn, p16 = self.canon[row], peek >> 16
        for i in range(5):  # codes of 12..16 bits, as the kernel's walk
            code = p16 >> (4 - i)
            if cn[5 + i] >= 0 and cn[i] <= code <= cn[5 + i]:
                sym = self.hv[row][(cn[10 + i] + code - cn[i]) & 0xFF]
                make = skip_entries if table == "skip" else pair_entries
                return int(make(12 + i, sym, dc))
        return 0

    @staticmethod
    def magnitude(peek, length, nbits):
        e = np.int64(length << 8 | nbits << 16)
        return int(_entry_magnitude(np.int64(peek), e))

    def boundary_pass(self):
        """-> (records [rows, 4]: start bit, DC predictor after the block,
        lane, slot (-1 after the lane's error block); err [lanes])."""
        b = self.b
        rec = np.zeros((b.total_rows, 4), np.int64)
        err = np.zeros(len(b.lane_start), bool)
        for lane in range(len(b.lane_start)):
            err[lane] = self.walk_lane(lane, rec)[0]
        return rec, err

    def walk_lane(self, lane, rec):
        """Pass 1 over one lane, its records into ``rec`` -> (flagged,
        symbols decoded, steps taken)."""
        b = self.b
        out, nblk = int(b.lane_out[lane]), int(b.lane_nblk[lane])
        bit = blk = slot = k = symbols = steps = 0
        dc = [0] * 4
        bad = False
        while blk < nblk:
            symbols += 1
            steps += 1
            comp, dcrow, acrow = self.slots[slot]
            peek = self.peek(lane, bit)
            e = self.entry(dcrow if k == 0 else acrow, peek, k == 0, "pair")
            if k == 0:
                length = e >> 27
                pred = dc[comp] + self.magnitude(peek, length, (e & 0x3F) - length)
                dc[comp] = (pred + 2**31) % 2**32 - 2**31  # i32 wrap
                rec[out + blk] = (bit, dc[comp], lane, slot)
            if not e:
                bad = True
                break
            adv1 = (e >> 6) & 0x7F
            two = (e >> 26) & 1 and k + adv1 < 64  # the first leaves it open
            symbols += 1 if two else 0
            bit += (e >> 13) & 0x3F if two else e & 0x3F
            k = min(k + ((e >> 19) & 0x7F if two else adv1), 64)
            if k == 64:
                k, blk, slot = 0, blk + 1, (slot + 1) % len(self.slots)
        rec[out + blk + 1 : out + nblk] = (0, 0, lane, -1)
        return bad or bit > int(b.lane_len[lane]) * 8 + 8, symbols, steps

    def block_pass(self, rec):
        """-> coefficients [rows, 64], each block decoded from its record."""
        coeffs = np.zeros((self.b.total_rows, 64), np.int64)
        for row, (bit, pred, lane, slot) in enumerate(rec.tolist()):
            if slot < 0:
                continue
            _, dcrow, acrow = self.slots[slot]
            coeffs[row, 0] = pred
            e = self.entry(dcrow, self.peek(lane, bit), True)
            if not e:
                continue
            bit += e & 0x3F
            k = 1
            while k < 64:
                peek = self.peek(lane, bit)
                e = self.entry(acrow, peek, False)
                if not e:
                    break
                adv = e >> 24
                coeffs[row, min(k + adv - 1, 63)] = self.magnitude(
                    peek, (e >> 8) & 0x1F, (e >> 16) & 0x1F)
                bit += e & 0x3F
                k = min(k + adv, 64)
        return coeffs


def _corrupt(plan, rng, n_flips):
    p = copy.copy(plan)
    p.scan_data = plan.scan_data.copy()
    pos = rng.choice(len(p.scan_data), size=n_flips, replace=False)
    p.scan_data[pos] ^= rng.integers(1, 256, size=n_flips).astype(np.uint8)
    return p


def _case(name):
    """(plans, must some lane be flagged) of one case."""
    if name == "cut":
        p = parse_jpeg(_read(RST[0]))
        s = p.segments[3]
        s.byte_end = s.byte_start + (s.byte_end - s.byte_start) // 3
        return [p], True
    base = parse_jpeg(_read(name))
    rng = np.random.default_rng(len(name))
    plans = [base] + [_corrupt(base, rng, 2) for _ in range(2)]
    # 64 one-bits inside a segment are an invalid prefix whatever precedes
    # them (a symbol is at most 32 bits), so this lane stops mid-segment.
    s = base.segments[5]
    mid = (s.byte_start + s.byte_end) // 2
    plans[1].scan_data[mid : mid + 8] = 0xFF
    return plans, True


@pytest.mark.parametrize("case", RST + ["cut"])
def test_two_pass_model_matches_plain(case):
    plans, flagged = _case(case)
    batch = prepare_lane_batch(plans)
    model = _Model(batch)
    rec, err = model.boundary_pass()
    got = model.block_pass(rec)
    want, want_err = decode_lanes_plain(lane_tensors(batch, "cpu"),
                                        len(batch.lane_start), batch.total_rows)
    np.testing.assert_array_equal(err, want_err.numpy())
    assert err.any() == flagged
    np.testing.assert_array_equal(got, want.numpy())
    # Every row is written by exactly one of: a decoded block, or the
    # zero rows after a lane's error block.
    assert ((rec[:, 3] >= 0) | (rec[:, 3] == -1)).all()


@pytest.mark.parametrize("lane", [0, 67, 134])
def test_4k_lane_symbol_count(lane):
    """The work of K3's serial pass on the main path: a lane of a 3840x2160
    q85 4:2:0 fixture frame (one MCU row, 1,440 blocks) holds 15,000-16,000
    symbols, 10-11 a block, which pairing walks in 9,500-10,500 steps; it
    is not flagged."""
    batch = prepare_lane_batch([parse_jpeg(_read("synth_3840x2160_s0_q85_rst1.jpg"))])
    rec = np.zeros((batch.total_rows, 4), np.int64)
    flagged, symbols, steps = _Model(batch).walk_lane(lane, rec)
    assert not flagged and int(batch.lane_nblk[lane]) == 1440
    assert 15_000 <= symbols <= 16_000, symbols
    assert 9_500 <= steps <= 10_500, steps
