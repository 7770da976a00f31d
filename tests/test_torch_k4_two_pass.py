"""K4's two-pass design rehearsed on the CPU, where its CUDA kernel cannot
run.

(a) The step cap. The plain twin gives a block at most ``MAX_BLOCK_STEPS``
(70) AC symbols. Every one of the 256 AC symbols advances the coefficient
index by at least 1 from any index 1..63, so 63 symbols close any block and
the cap is never reached: the CUDA kernel carries no counter. A hand-packed
block of 63 one-step symbols shows 63 is attained and enough.

(b) The tables ``_runner`` hands the CUDA kernel
(``kernel_tables_device``), against the twin's own symbol resolution
(``_resolve`` + ``_magnitude``) on every 11-bit peek of K4's eight table
rows.

(c) A NumPy model of the kernel's split over word columns, held to
``decode_words_plain`` in every element and flag: pass 1 walks each lane
through the pair table and records, per (block, lane), the start bit and the
DC predictor after the block; pass 2 decodes each block on its own from its
start bit through the skip table. The model is ``_Model`` of
``test_torch_k3_two_pass.py`` over K4's stream (big-endian words of a
column, zeros for every word index >= W) and K4's lane-minor layouts; it
follows the same rules as ``csrc/huffman_common.cuh``.
"""

import types

import numpy as np
import pytest
import torch
from test_torch_device_kernel import _corrupt, _plans, _port
from test_torch_k3_two_pass import _entry_magnitude, _fields, _Model, _plan

from jpeg_tpu_torch.entropy import device_kernel as k4
from jpeg_tpu_torch.entropy.device_huffman import (
    T11,
    _magnitude,
    _resolve,
    _size_advance,
    lane_tables,
    skip_entries,
    slot_rows,
)

# --------------------------------------------------------------------------
# (a) the step cap


def test_every_ac_symbol_advances_the_coefficient_index():
    """For each of the 256 AC symbols and each open index 1..63, the twin's
    next index (``decode_words_plain``'s ``coef_next``) is larger, and equals
    the tables' advance: no block takes more than 63 AC symbols."""
    sym = torch.arange(256).repeat_interleave(63)
    coef = torch.arange(1, 64).repeat(256)
    eob, zrl = sym == 0x00, sym == 0xF0
    pos = coef + torch.minimum((sym >> 4) & 0xF, 63 - coef)
    nxt = torch.where(eob, 64,
                      torch.where(zrl, (coef + 16).clamp(max=64), pos + 1))
    assert bool((nxt > coef).all()) and bool((nxt <= 64).all())
    adv = torch.from_numpy(_size_advance(sym.numpy(), dc=False)[1])
    assert int(adv.min()) >= 1
    np.testing.assert_array_equal(torch.minimum(coef + adv, torch.tensor(64)),
                                  nxt)
    assert k4.MAX_BLOCK_STEPS > 63


def _pack_bits(bits: str) -> np.ndarray:
    bits += "1" * (-len(bits) % 8)
    return np.array([int(bits[i : i + 8], 2) for i in range(0, len(bits), 8)],
                    np.uint8)


def _code(table, sym: int) -> str:
    i = int(np.flatnonzero(table.values == sym)[0])
    return format(int(table.codes[i]), f"0{int(table.lengths[i])}b")


@pytest.mark.parametrize("cap,flagged", [(70, False), (63, False), (62, True)])
def test_longest_block_takes_63_symbols(monkeypatch, cap, flagged):
    """A block of 63 (run 0, size 1) symbols is the longest there is: the
    twin closes it under a cap of 63 and flags it under 62. The model, which
    counts nothing, equals the twin under the real cap."""
    plan = _port(_plans(1, 1, shape=(8, 8), gray=True, quality=85))[0]
    assert len(plan.segments) == 1 and plan.blocks_per_mcu == 1
    dc, ac = plan.dc_tables[0], plan.ac_tables[0]
    mags = "".join("1" if i % 3 else "0" for i in range(63))
    plan.scan_data = _pack_bits(
        _code(dc, 0) + "".join(_code(ac, 0x01) + m for m in mags))
    seg = plan.segments[0]
    seg.byte_start, seg.byte_end = 0, len(plan.scan_data)
    monkeypatch.setattr(k4, "MAX_BLOCK_STEPS", cap)
    run, args, max_mcus, _ = k4.kernel_runner(plan, device="cpu")
    out, err = run(*args)
    assert bool(err[0, 0]) == flagged
    if not flagged:
        want = [0] + [1 if m == "1" else -1 for m in mags]
        assert out[0, 0, :, 0].tolist() == want
    if cap == 70:
        got, got_err = _WordModel(plan, args, max_mcus).decode()
        np.testing.assert_array_equal(got, out.numpy())
        np.testing.assert_array_equal(got_err, err[0].numpy())


# --------------------------------------------------------------------------
# (b) the kernel's tables


def _kernel_tables(plan):
    return [t.numpy() for t in k4.kernel_tables_device(
        *lane_tables(plan), slot_rows(plan), "cpu")]


@pytest.mark.parametrize("source", [
    "synth_512x384_s2_q85_rst1.jpg", "synth_512x384_s4_q85_rst1_gray.jpg",
    "synth_3840x2160_s0_q85_rst1.jpg", "optimize"])
def test_runner_tables_agree_with_resolve(source):
    """Each of the eight rows (4 DC + 4 AC) that a slot uses is in the
    kernel's tables, and there its skip and pair entries give the twin's
    length, magnitude bits, advance and value on every 11-bit peek; codes
    longer than 11 bits have no entry and get ``skip_entries`` of the
    canonical walk's result."""
    plan = _plan(source)
    lut, hv, canon = lane_tables(plan)
    slots = slot_rows(plan)
    skip, pair, khv, kcanon, kslots = _kernel_tables(plan)
    at = {}
    for (_, d, a), (_, kd, ka) in zip(slots, kslots):
        at[int(d)], at[4 + int(a)] = int(kd), int(ka)
    assert len(skip) == len(pair) == len(set(at.values())) == len(at)
    np.testing.assert_array_equal(kslots[:, 0], slots[:, 0])
    rng = np.random.default_rng(len(source))
    peek = ((np.arange(T11, dtype=np.int64) << 21)
            | rng.integers(0, 1 << 21, T11))
    for row in range(8):
        dc = row < 4
        if row not in at:
            continue  # no slot decodes with this table: the kernel never reads it
        np.testing.assert_array_equal(khv[at[row]], hv[row])
        np.testing.assert_array_equal(kcanon[at[row]], canon[row])
        ln, sym = (x.numpy() for x in _resolve(
            torch.from_numpy(lut[row]).long(), torch.from_numpy(hv[row]).long(),
            canon[row].tolist(), torch.from_numpy(peek)))
        eob, zrl = sym == 0x00, sym == 0xF0
        nbits = sym if dc else np.where(eob | zrl, 0, sym & 0xF)
        want_mag = _magnitude(torch.from_numpy(peek), torch.from_numpy(ln),
                              torch.from_numpy(nbits)).numpy()
        e = skip[at[row]].astype(np.int64)
        p = pair[at[row]].astype(np.int64)
        short = (ln > 0) & (ln <= 11)
        np.testing.assert_array_equal(e != 0, short)
        np.testing.assert_array_equal(p != 0, short)
        e = np.where(short, e, np.where(ln > 0, skip_entries(ln, sym, dc), 0))
        ok = ln > 0
        used, length, size, adv = _fields(e)
        np.testing.assert_array_equal(length[ok], ln[ok])
        np.testing.assert_array_equal(size[ok], nbits[ok])
        np.testing.assert_array_equal(used[ok], (ln + nbits)[ok])
        np.testing.assert_array_equal(_entry_magnitude(peek, e)[ok], want_mag[ok])
        want_adv = 1 if dc else np.where(
            eob, 64, np.where(zrl, 16, ((sym >> 4) & 0xF) + 1))
        np.testing.assert_array_equal(adv[ok], np.broadcast_to(want_adv, adv.shape)[ok])
        # Pass 1's single-symbol fields are the skip table's.
        np.testing.assert_array_equal((p & 0x3F)[short], used[short])
        np.testing.assert_array_equal(((p >> 6) & 0x7F)[short], adv[short])
        if dc:
            np.testing.assert_array_equal((p >> 27)[short], length[short])


# --------------------------------------------------------------------------
# (c) the two-pass split over word columns


class _WordModel(_Model):
    """``_Model`` over K4's arguments: lane l's stream is column l of
    ``words`` (zeros past W), its records and coefficients lane-minor."""

    def __init__(self, plan, args, max_mcus):
        words, _, _, nblk, bitend = (a.numpy() for a in args)
        skip, pair, hv, canon, slots = _kernel_tables(plan)
        self.W, self.S = words.shape
        self.cols = (words.astype(np.int64) & 0xFFFFFFFF).T.tolist()
        self.total = max_mcus * len(slots)
        self.shape = (max_mcus, len(slots))
        super().__init__(types.SimpleNamespace(
            data=b"", skip=skip, pair=pair, skip_hv=hv, skip_canon=canon,
            skip_slots=slots, lane_start=np.zeros(self.S, np.int64),
            lane_len=bitend[0] // 8, lane_nblk=nblk[0],
            lane_out=np.zeros(self.S, np.int64),
            total_rows=self.total * self.S))
        assert (bitend[0] % 8 == 0).all()

    def peek(self, lane, bit):
        """32 bits of a column at ``bit``; a word index >= W reads 0."""
        col, w = self.cols[lane], bit >> 5
        a = col[w] if w < self.W else 0
        b = col[w + 1] if w + 1 < self.W else 0
        return (((a << 32) | b) >> (32 - (bit & 31))) & 0xFFFFFFFF

    def decode(self):
        """Both passes -> (out [max_mcus, bpm, 64, S], err [S])."""
        rec = np.full((self.total, self.S, 4), -2, np.int64)  # -2: unwritten
        err = np.zeros(self.S, bool)
        for lane in range(self.S):
            mine = rec[:, lane]  # a view: block b's record at [b, lane]
            err[lane] = self.walk_lane(lane, mine)[0]
            # Past the lane's nblk (the walk filled the rows after an error
            # block): zeros.
            mine[int(self.b.lane_nblk[lane]):] = (0, 0, lane, -1)
        assert (rec[..., 3] >= -1).all()  # every record written
        coeffs = self.block_pass(rec.reshape(-1, 4))
        out = coeffs.reshape(*self.shape, self.S, 64).transpose(0, 1, 3, 2)
        return out, err


def _cut(refs):
    s = refs[0].segments[0]
    s.byte_end = s.byte_start + (s.byte_end - s.byte_start) // 3
    return refs


def _mixed():
    rng = np.random.default_rng(60)
    from jpeg_tpu.io.container import parse_jpeg as ref_parse
    from jpeg_tpu.models.encoder import encode_rgb

    return [ref_parse(encode_rgb(
        rng.integers(0, 256, (*shape, 3), dtype=np.uint8), quality=85,
        subsampling=(2, 2), restart_interval_mcus=ri))
        for shape, ri in [((48, 64), 4), ((80, 96), 8), ((64, 48), 2)]]


# name -> (reference plans, must some lane be flagged)
CASES = {
    "clean_420": (lambda: _plans(11, 2, quality=85, subsampling=(2, 2),
                                 restart_interval_mcus=2), False),
    "clean_422": (lambda: _plans(12, 2, quality=85, subsampling=(2, 1),
                                 restart_interval_mcus=3), False),
    "clean_gray": (lambda: _plans(13, 2, gray=True, quality=85,
                                  restart_interval_mcus=6), False),
    "single_lane": (lambda: _plans(3, 1, quality=85, subsampling=(2, 2)),
                    False),
    "corrupt0": (lambda: _corrupt(_plans(300, 3, quality=85,
                                         subsampling=(2, 2),
                                         restart_interval_mcus=2), 400), True),
    "corrupt1": (lambda: _corrupt(_plans(301, 3, quality=85,
                                         subsampling=(2, 2),
                                         restart_interval_mcus=2), 401), True),
    "cut_past_w": (lambda: _cut(_plans(7, 1, shape=(64, 80), quality=85,
                                       subsampling=(1, 1))), True),
    "12bit": (lambda: _plans(5, 1, quality=97, subsampling=(1, 1),
                             precision=12, engine="python",
                             restart_interval_mcus=3), False),
    "long_codes": (lambda: _plans(4, 1, shape=(80, 80), quality=92,
                                  subsampling=(2, 2), restart_interval_mcus=5,
                                  optimize=True), False),
    "mixed_intervals": (_mixed, False),
}


@pytest.mark.parametrize("bucket", ["w8", "w256"])
@pytest.mark.parametrize("case", CASES)
def test_two_pass_model_matches_plain(case, bucket):
    """Every element of ``out`` and every flag, for ``kernel_runner``'s W
    (a multiple of 8 words) and ``kernel_runner_batch``'s (of 256)."""
    make, flagged = CASES[case]
    plans = _port(make())
    if bucket == "w8":
        run, args, max_mcus, S = k4.kernel_runner(plans[0], device="cpu")
    else:
        run, args, max_mcus, S, _ = k4.kernel_runner_batch(plans, device="cpu")
    assert args[0].shape[0] % (8 if bucket == "w8" else 256) == 0
    want, want_err = run(*args)
    got, err = _WordModel(plans[0], args, max_mcus).decode()
    np.testing.assert_array_equal(err, want_err[0].numpy())
    np.testing.assert_array_equal(got, want.numpy())
    if flagged:
        assert err.any()
    if case == "mixed_intervals" and bucket == "w256":
        nblk = args[3][0].numpy()
        assert len(set(nblk.tolist())) > 1  # zeros past a lane's blocks
    if case == "cut_past_w":
        assert err[0]  # the lane ran past W, into the zeros
