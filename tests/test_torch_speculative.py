"""The C++ runtime's speculative pieces in jpeg_tpu_torch against jpeg_tpu:
``native_decode_planes(speculative=, n_chunks=)`` on streams without
restart markers (the cases of ``tests/test_speculative.py`` that need no
reference corpus, their streams from the port's encoder instead of PIL),
its fixed chunk count (``4 * n_threads`` unless ``n_chunks`` is given,
the same at every call, as the bench reports it), and ``native_decode_gap``,
the gap recovery of ``entropy/device_spec.py``, against the JAX binding
and against the port's NumPy oracle loop."""

import builtins
import os

import numpy as np
import pytest

import jpeg_tpu.runtime as ref_rt
from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu_torch import bench, encode_rgb
from jpeg_tpu_torch import runtime as rt
from jpeg_tpu_torch.entropy import device_spec as spec
from jpeg_tpu_torch.io.container import parse_jpeg


def _assert_spec_equals_seq(data, **kw):
    """Speculative planes == sequential planes == the JAX runtime's."""
    plan = parse_jpeg(data)
    assert len(plan.segments) == 1
    seq = [p.copy() for p in rt.native_decode_planes(
        plan, speculative=False, reuse_buffer=False)]
    got = rt.native_decode_planes(plan, speculative=True, reuse_buffer=False,
                                  **kw)
    want = ref_rt.native_decode_planes(ref_parse(data), speculative=True,
                                       reuse_buffer=False, **kw)
    for a, b, c in zip(seq, got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


@pytest.mark.parametrize("subsampling", [(1, 1), (2, 1), (2, 2)])
def test_random_images(subsampling):
    rng = np.random.default_rng(sum(subsampling))
    for _trial in range(2):
        h = int(rng.integers(160, 400))
        w = int(rng.integers(160, 400))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.clip(
            128 + 90 * np.sin(xx / 17)[..., None] * np.cos(yy / 13)[..., None]
            * np.ones(3) + rng.normal(0, 20, (h, w, 3)), 0, 255
        ).astype(np.uint8)
        _assert_spec_equals_seq(encode_rgb(img, quality=90,
                                           subsampling=subsampling))


def test_many_chunks_small_stream():
    """Chunk count capped by stream size; must still be identical."""
    img = np.random.default_rng(7).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    _assert_spec_equals_seq(encode_rgb(img, quality=95), n_threads=8)


@pytest.mark.parametrize("n_chunks", [1, 3, 64])
def test_explicit_chunk_counts(n_chunks):
    """``n_chunks`` sets the chunk count; the planes stay bit-identical."""
    img = np.random.default_rng(8).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    data = encode_rgb(img, quality=90, subsampling=(2, 2))
    _assert_spec_equals_seq(data, n_chunks=n_chunks, n_threads=4)


def _spy_spec(monkeypatch) -> list:
    """Make ``rt.load`` return the runtime with ``jt_decode_scan_planes_spec``
    wrapped; returns the list its calls' (n_chunks, n_threads) land in."""
    lib = rt.load()
    seen = []

    class Spy:
        def __getattr__(self, name):
            return getattr(lib, name)

        def jt_decode_scan_planes_spec(self, *args):
            seen.append(args[-2:])
            return lib.jt_decode_scan_planes_spec(*args)

    monkeypatch.setattr(rt, "load", Spy)
    return seen


@pytest.mark.parametrize("n_threads,n_chunks,want", [(1, None, 4),
                                                     (2, None, 8),
                                                     (3, None, 12),
                                                     (4, None, 16),
                                                     (8, None, 32),
                                                     (2, 5, 5)])
def test_chunk_count_is_four_per_thread(monkeypatch, n_threads, n_chunks,
                                        want):
    """Without ``n_chunks`` the speculative decode takes ``4 * n_threads``
    chunks, the first count the JAX runtime's tuner tries."""
    seen = _spy_spec(monkeypatch)
    img = np.random.default_rng(11).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    data = encode_rgb(img, quality=90)
    got = rt.native_decode_planes(parse_jpeg(data), n_threads=n_threads,
                                  speculative=True, n_chunks=n_chunks,
                                  reuse_buffer=False)
    assert seen == [(want, n_threads)]
    want_planes = ref_rt.native_decode_planes(ref_parse(data),
                                              speculative=False,
                                              reuse_buffer=False)
    for a, b in zip(got, want_planes):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_threads", [2, 4, 8])
def test_default_chunk_count_is_the_same_every_call(monkeypatch, n_threads):
    """Five calls in a row on one frame all take ``4 * n_threads`` chunks
    and open no file for writing: no state is kept between calls."""
    seen = _spy_spec(monkeypatch)
    img = np.random.default_rng(12).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    plan = parse_jpeg(encode_rgb(img, quality=90))
    want = [p.copy() for p in rt.native_decode_planes(
        plan, speculative=False, reuse_buffer=False)]
    writes = []
    real_open = builtins.open

    def spy_open(file, mode="r", *args, **kw):
        if any(c in mode for c in "wax+"):
            writes.append(file)
        return real_open(file, mode, *args, **kw)

    monkeypatch.setattr(builtins, "open", spy_open)
    for _ in range(5):
        got = rt.native_decode_planes(plan, n_threads=n_threads,
                                      speculative=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    monkeypatch.undo()
    assert seen == [(4 * n_threads, n_threads)] * 5
    assert writes == []
    assert rt.spec_tuner_snapshot() == {}


def test_bench_reports_the_fixed_chunk_count():
    """``bench.spec_tuner_detail`` gives ``4 * cores`` for a restart-free
    frame at or above the 64 KB threshold, None below it, an empty tuner
    snapshot and ``pgo`` off."""
    cores = os.cpu_count() or 1
    rng = np.random.default_rng(13)
    big = parse_jpeg(encode_rgb(rng.integers(0, 256, (256, 256, 3),
                                             dtype=np.uint8), quality=95))
    small = parse_jpeg(encode_rgb(rng.integers(0, 256, (64, 64, 3),
                                               dtype=np.uint8), quality=95))
    assert len(big.segments) == len(small.segments) == 1
    assert len(big.scan_data) >= 65536 > len(small.scan_data)
    for plan, want in ((big, 4 * cores if cores > 1 else None),
                       (small, None)):
        assert bench.spec_tuner_detail(plan) == {
            "spec_chunks": want, "spec_tuner": {}, "pgo": "off"}


def test_low_entropy_stream():
    """Flat image -> highly repetitive bitstream (sync-hostile); the
    sequential fallback must keep it bit-identical."""
    _assert_spec_equals_seq(encode_rgb(np.full((256, 256, 3), 128, np.uint8),
                                       quality=85))


def _boundaries(plan):
    """Bit positions after each MCU of a restart-free scan (C++ decode)."""
    res = rt.native_decode_gap(plan, 0, len(plan.scan_data),
                               np.zeros(0, np.int64), plan.n_mcus)
    assert res is not None and len(res[1]) == plan.n_mcus
    return res


@pytest.mark.parametrize("sub", [(1, 1), (2, 2), None])
def test_native_decode_gap_matches_jax(sub):
    """From bit 0 (the whole scan), from MCU boundaries up to a stop, and
    from guessed byte starts: the same blocks and positions as the JAX
    binding, or None from both."""
    img = np.random.default_rng(14).integers(0, 256, (128, 160, 3), dtype=np.uint8)
    data = (encode_rgb(img[..., 0], quality=85, grayscale=True) if sub is None
            else encode_rgb(img, quality=85, subsampling=sub))
    plan, ref = parse_jpeg(data), ref_parse(data)
    end = len(plan.scan_data)
    blocks, pos = _boundaries(plan)
    # Raw DC deltas: their running sum per component is the decoded DC.
    want = rt.native_decode_coefficients(plan, reuse_buffer=False)
    slot_comp = [ci for ci, _ in plan.component_block_slots()]
    flat = blocks.reshape(-1, 64).astype(np.int64)
    for c in set(slot_comp):
        rows = np.tile(np.array(slot_comp) == c, plan.n_mcus)
        flat[rows, 0] = np.cumsum(flat[rows, 0])
    np.testing.assert_array_equal(flat, want)
    cases = [(0, pos[[7, 20]], plan.n_mcus), (int(pos[3]), pos[[3]], 10),
             (int(pos[3]), pos[[11, 30]], 50), (int(pos[5]), pos[[9]], 2)]
    cases += [(b * 8, pos[10:], plan.n_mcus) for b in (1, 17, end // 2)]
    for start, stops, max_mcus in cases:
        stops = np.asarray(stops, np.int64)
        got = rt.native_decode_gap(plan, start, end, stops, max_mcus)
        ref_got = ref_rt.native_decode_gap(ref, start, end, stops, max_mcus)
        assert (got is None) == (ref_got is None)
        if got is not None:
            for a, b in zip(got, ref_got):
                np.testing.assert_array_equal(a, b)
    assert rt.native_decode_gap(plan, int(pos[3]), end, pos[[3]], 10)[0].shape == (
        0, plan.blocks_per_mcu, 64)


def test_native_decode_gap_reports_corruption():
    img = np.random.default_rng(15).integers(0, 256, (48, 48, 3), dtype=np.uint8)
    plan = parse_jpeg(encode_rgb(img, quality=85))
    bad = parse_jpeg(encode_rgb(img, quality=85))
    bad.scan_data = np.full_like(plan.scan_data, 0xFF)  # runs of ones
    assert rt.native_decode_gap(bad, 0, len(bad.scan_data),
                                np.zeros(0, np.int64), 4) is None


@pytest.mark.parametrize("sub", [(1, 1), (2, 2)])
def test_host_gap_decode_matches_the_oracle_loop(sub):
    """The merge's gap recovery through ``jt_decode_gap`` equals the NumPy
    oracle loop it replaced: blocks with predicted DC, the DC after, where
    it resumes, and the count; at a stop, at the MCU budget, and from a
    cursor whose parse never meets a stop."""
    img = np.random.default_rng(16).integers(0, 256, (128, 128, 3), dtype=np.uint8)
    plan = parse_jpeg(encode_rgb(img, quality=85, subsampling=sub))
    _blocks, pos = _boundaries(plan)
    n_comp = len(plan.components)
    stop_pos = np.sort(np.concatenate([pos[[9, 15, 15]], pos[[15]] + 3]))
    later = (stop_pos.astype(np.int64), np.array([2, 1, 3, 2], np.int32),
             np.array([0, 4, 7, 1], np.int32))
    prev = np.arange(n_comp, dtype=np.int64) * 5
    for start, n_left in ((int(pos[2]), 40), (int(pos[10]), 40),
                          (int(pos[2]), 3), (int(pos[20]), 10)):
        got = spec._host_gap_decode(plan, start, prev, later, n_left,
                                    len(plan.scan_data))
        want = spec._oracle_gap_decode(plan, start, prev, later, n_left)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[2:] == want[2:]
    # pos[10] resumes at the lowest later lane holding pos[15]: lane 1.
    assert spec._host_gap_decode(plan, int(pos[10]), prev, later, 40,
                                 len(plan.scan_data))[2:] == ((1, 4), 5)
