"""The shared Huffman tables of ``jpeg_tpu_torch.entropy.tables`` and the
packed LUTs of the C++ runtime built from them: one build per DHT content,
read-only arrays, no state that passes from one plan to another, a fixed
bound, the answers of unshared tables bit for bit, and the same under
threads. Imports no JAX."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from jpeg_tpu_torch import decode_bytes, encode_rgb
from jpeg_tpu_torch import runtime
from jpeg_tpu_torch.entropy import annex_k, tables
from jpeg_tpu_torch.entropy.tables import HuffmanTable, shared_table, table_key
from jpeg_tpu_torch.io import container
from jpeg_tpu_torch.io.container import JPEGError, parse_jpeg
from jpeg_tpu_torch.io.corpus import synthetic_image
from jpeg_tpu_torch.models.decoder import host_planes
from jpeg_tpu_torch.runtime import NativeDecodeError, native_decode_planes

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens", "torch")
GOLDENS = ["synth_3840x2160_s0_q85_rst1.jpg", "synth_512x384_s2_q85_rst1.jpg",
           "synth_512x384_s3_q85_rst0.jpg",
           "synth_512x384_s12_q85_rst0_gray_prog.jpg"]
FIELDS = ("bits", "values", "lengths", "codes", "lut_value", "lut_length")


def _golden(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _stream(i: int = 0, **enc) -> bytes:
    enc = dict(dict(quality=85, subsampling=(2, 2), restart_interval_mcus=2),
               **enc)
    return encode_rgb(synthetic_image(64, 48, i), **enc)


def _all_tables(plan) -> list:
    out = list(plan.dc_tables) + list(plan.ac_tables)
    for s in plan.prog_scans:
        out += list(s.dc_tables) + list(s.ac_tables)
    return out


def _unshared(monkeypatch) -> None:
    """Parses from here on build every table afresh, as before the cache."""
    monkeypatch.setattr(container, "shared_table",
                        lambda b, v: (HuffmanTable.build(b, v), False))
    monkeypatch.setattr(container, "empty_table", lambda: HuffmanTable.build(
        np.zeros(16, np.uint8), np.zeros(0, np.uint8)))


def test_same_dht_bytes_share_their_arrays():
    """Two frames with the same tables hold the same arrays in their own
    table objects; a frame with optimised tables holds its own."""
    a, b = parse_jpeg(_stream(0)), parse_jpeg(_stream(1))
    opt = parse_jpeg(_stream(0, optimize=True))
    for ta, tb in zip(_all_tables(a), _all_tables(b)):
        assert ta is not tb
        for f in FIELDS:
            assert getattr(ta, f) is getattr(tb, f)
    for k in range(2):
        assert opt.dc_tables[k].lut_value is not a.dc_tables[k].lut_value
        assert opt.ac_tables[k].lut_length is not a.ac_tables[k].lut_length
        assert table_key(a.ac_tables[k]) == table_key(b.ac_tables[k])
    # the unused slots all hold the one all-invalid table
    assert a.dc_tables[3].lut_value is opt.ac_tables[2].lut_value
    assert not a.dc_tables[3].lut_length.any()
    # and the runtime packs each slot set once
    assert runtime._packed_luts(a.dc_tables) is runtime._packed_luts(b.dc_tables)
    assert runtime._packed_luts(a.ac_tables) is not runtime._packed_luts(
        opt.ac_tables)


@pytest.mark.parametrize("name", GOLDENS)
def test_shared_tables_decode_as_unshared(name, monkeypatch):
    """Planes and RGB from the shared tables equal those from unshared
    tables (``HuffmanTable.build``), bit for bit."""
    data = _golden(name)
    plan = parse_jpeg(data)
    planes = [p.copy() for p in host_planes(plan, n_threads=1)]
    rgb = decode_bytes(data, path="fast", device="cpu")
    _unshared(monkeypatch)
    fresh = parse_jpeg(data)
    for t, u in zip(_all_tables(plan), _all_tables(fresh)):
        assert table_key(u) is None
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(t, f), getattr(u, f))
            assert getattr(t, f).dtype == getattr(u, f).dtype
    if not plan.progressive:
        for p, q in zip(planes, native_decode_planes(fresh, n_threads=1)):
            np.testing.assert_array_equal(p, q)
    for p, q in zip(planes, host_planes(fresh, n_threads=1)):
        np.testing.assert_array_equal(p, q)
    np.testing.assert_array_equal(
        rgb, decode_bytes(data, path="fast", device="cpu"))


def test_shared_arrays_refuse_writes():
    plan = parse_jpeg(_stream(2))
    arrays = [getattr(t, f) for t in _all_tables(plan) for f in FIELDS]
    arrays += [runtime._packed_luts(plan.dc_tables),
               runtime._packed_luts(plan.ac_tables)]
    for a in arrays:
        assert not a.flags.writeable
        with pytest.raises(ValueError):
            a[...] = 0
        with pytest.raises(ValueError):
            a.setflags(write=True)
    # HuffmanTable.build's arrays stay the caller's to write
    t = HuffmanTable.build(annex_k.DC_LUMA_BITS, annex_k.DC_LUMA_VALS)
    t.lut_value[0] = t.lut_value[0]


def test_reassigned_table_reaches_no_other_plan():
    """A plan whose tables a caller reassigns decodes with what it was
    given (every prefix invalid here), and a later parse of the same bytes
    gets the tables of the stream."""
    data = _stream(3)
    want = [p.copy() for p in native_decode_planes(parse_jpeg(data))]
    bad = parse_jpeg(data)
    native_decode_planes(bad)  # its packed LUTs are the shared ones
    bad = parse_jpeg(data)
    for t in bad.dc_tables:
        t.lut_length = np.zeros_like(t.lut_length)
        t.values = np.array([17], np.uint8)
    with pytest.raises(NativeDecodeError):
        native_decode_planes(bad)
    again = parse_jpeg(data)
    assert all(table_key(t) is not None for t in again.dc_tables)
    assert again.dc_tables[0].values.tolist() == list(annex_k.DC_LUMA_VALS)
    for p, q in zip(want, native_decode_planes(again)):
        np.testing.assert_array_equal(p, q)


def _distinct(i: int) -> tuple[list, list]:
    """A valid table of its own for each i < 256: one code of length 1,
    for symbol i."""
    return [1] + [0] * 15, [i]


def test_cache_keeps_its_bound():
    """More distinct tables and slot sets than the bounds: each cache stays
    at its bound, the oldest are rebuilt when asked again, and a stream
    still decodes as with unshared tables."""
    tables.TABLES.clear()
    n = tables.TABLE_CACHE_SIZE + 16
    made = [shared_table(*_distinct(i)) for i in range(n)]
    assert len(tables.TABLES) == tables.TABLE_CACHE_SIZE
    assert not any(reused for _, reused in made)
    assert table_key(made[0][0]) is None  # dropped: packed afresh
    assert table_key(made[-1][0]) is not None
    sets = [[t for t, _ in made[i : i + 4]] for i in range(n - 3)]
    packed = [runtime._packed_luts(s) for s in sets]
    assert len(runtime._PACKED) == runtime.PACKED_CACHE_SIZE
    for s, p in zip(sets, packed):
        np.testing.assert_array_equal(p, runtime._pack(s))
    t, reused = shared_table(*_distinct(0))
    assert not reused and t.lut_value is not made[0][0].lut_value
    np.testing.assert_array_equal(t.lut_value, made[0][0].lut_value)
    data = _stream(4)
    want = [p.copy() for p in native_decode_planes(parse_jpeg(data))]
    for i in range(n):  # the stream's tables dropped again
        shared_table(*_distinct(i))
    for p, q in zip(want, native_decode_planes(parse_jpeg(data))):
        np.testing.assert_array_equal(p, q)


def _dht(stream: bytes, bits: bytes, values: bytes) -> bytes:
    """``stream`` with one more DHT segment, of DC table 0, after its SOI."""
    body = b"\x00" + bits + values
    return (stream[:2] + b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big")
            + body + stream[2:])


BAD_DHT = {
    # counts that disagree with HUFFVAL: 3 codes declared, 2 values given
    "counts": (lambda: HuffmanTable.from_bits_values(
        [0, 3] + [0] * 14, [0, 1]), ValueError, "DHT mismatch"),
    # three codes of length 1: the code space is exhausted
    "oversubscribed": (lambda: parse_jpeg(_dht(
        _stream(5), bytes([2] + [0] * 14 + [1]), bytes([1, 2, 3]))),
        ValueError, "code space exhausted"),
    # a DC symbol over 16, refused before the table is looked up
    "dc_symbol": (lambda: parse_jpeg(_dht(
        _stream(5), bytes([0, 2] + [0] * 14), bytes([1, 17]))),
        JPEGError, "> 16"),
}


@pytest.mark.parametrize("case", sorted(BAD_DHT))
def test_bad_dht_raises_and_leaves_no_entry(case):
    run, error, match = BAD_DHT[case]
    with pytest.raises(error, match=match):
        run()
    with pytest.raises(error, match=match):  # and again: nothing was kept
        run()
    for key in ((bytes([0, 3] + [0] * 14), bytes([0, 1])),
                (bytes([2] + [0] * 14 + [1]), bytes([1, 2, 3])),
                (bytes([0, 2] + [0] * 14), bytes([1, 17]))):
        assert tables.TABLES.peek(key) is None


def test_threads_give_the_serial_results():
    """Eight threads parsing a mix of two table sets from an empty cache:
    every plan equals its serial parse, and each table set ends up with
    one set of arrays."""
    streams = [_stream(0), _stream(1, optimize=True)]
    items = [streams[i % 2] for i in range(64)]
    serial = [parse_jpeg(x) for x in items]
    want = [[p.copy() for p in native_decode_planes(parse_jpeg(s), n_threads=1)]
            for s in streams]
    tables.TABLES.clear()

    def work(k):
        plan = parse_jpeg(items[k])
        return plan, [p.copy() for p in native_decode_planes(plan, n_threads=1)]

    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(work, range(64)))
    for k, ((plan, planes), ref) in enumerate(zip(got, serial)):
        for t, u in zip(_all_tables(plan), _all_tables(ref)):
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(t, f), getattr(u, f))
        for p, q in zip(planes, want[k % 2]):
            np.testing.assert_array_equal(p, q)
    kept = {}
    for plan, _ in got:
        for t in _all_tables(plan):
            key = table_key(t)
            assert key is not None
            assert kept.setdefault(key, t.lut_value) is t.lut_value
