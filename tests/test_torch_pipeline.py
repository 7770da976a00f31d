"""The whole slice: jpeg_tpu_torch's corpus decoder and single-image entry
points against jpeg_tpu's, the hybrid route against the host route, error
isolation, and the rule that nothing but a lane error, an ineligible plan or
a table mismatch sends a claimed image back to the host."""

import os

import numpy as np
import pytest
import torch

from jpeg_tpu.io.corpus import synthetic_image
from jpeg_tpu.models.decoder import decode_bytes as ref_decode_bytes
from jpeg_tpu.models.encoder import encode_rgb, encode_rgb_progressive
from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder as RefDecoder
from jpeg_tpu_torch import BatchedCorpusDecoder, decode_bytes, decode_file
from jpeg_tpu_torch.entropy import device_huffman

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens", "torch")
SMALL = ["synth_512x384_s2_q85_rst1.jpg", "synth_512x384_s3_q85_rst0.jpg",
         "synth_512x384_s4_q85_rst1_gray.jpg"]


def _corpus(n, **enc):
    enc = dict(dict(quality=85, subsampling=(2, 2), restart_interval_mcus=3),
               **enc)
    return [encode_rgb(synthetic_image(96, 64, seed=i), **enc) for i in range(n)]


def _within_one(a, b):
    assert a.shape == b.shape
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05


def _poisoned(data: bytes) -> bytes:
    """Overwrite the middle of restart segment 1 with eight stuffed 0xFF
    bytes: 64 one-bits, an invalid prefix for any decoder."""
    b = bytearray(data)
    rst = [i for i in range(len(b) - 1)
           if b[i] == 0xFF and 0xD0 <= b[i + 1] <= 0xD7]
    mid = (rst[0] + rst[1]) // 2
    while b[mid - 1] == 0xFF:
        mid += 1
    b[mid : mid + 16] = b"\xff\x00" * 8
    return bytes(b)


def test_hybrid_matches_jax_hybrid():
    items = _corpus(12)
    ref = RefDecoder(workers=2, hybrid_device=True, device_batch=2,
                     _device_interpret=True).decode_all(items)
    dec = BatchedCorpusDecoder(workers=2, hybrid_device=True, device_batch=2,
                               device="cpu")
    got = dec.decode_all(items)
    assert dec.device_frames > 0 and dec.entropy_launches > 0
    assert dec.pixel_launches == 1
    for g, r in zip(got, ref):
        assert g.ok and r.ok
        _within_one(g.rgb, r.rgb)


def _twelve_bit() -> bytes:
    img = synthetic_image(48, 32, seed=3)
    return encode_rgb(img.astype(np.uint16) * 16, quality=90, precision=12,
                      engine="python")


def test_hybrid_equals_host_route_with_isolation():
    """Who decoded the entropy must not matter; bad items become records.
    A progressive item decodes on the host route (the device thread hands
    it back), equal to the single-image fast path."""
    prog = encode_rgb_progressive(synthetic_image(96, 64, seed=50), quality=85)
    items = ([b"not a jpeg", prog, _twelve_bit()]
             + [open(os.path.join(FIXTURES, f), "rb").read() for f in SMALL]
             + _corpus(9)
             + [_poisoned(_corpus(1)[0])])
    host = BatchedCorpusDecoder(workers=2, device="cpu").decode_all(items)
    dec = BatchedCorpusDecoder(workers=2, hybrid_device=True, device_batch=2,
                               device="cpu")
    hyb = dec.decode_all(items)
    assert dec.device_frames > 0
    assert dec.fallback_frames >= 1  # the poisoned item, claimed first
    assert not hyb[0].ok and "JPEGError" in hyb[0].error
    assert hyb[1].ok
    # The 12-bit item, once an error record, is decoded inline through the
    # compat route: u16, equal to the single-image decode.
    assert hyb[2].ok and hyb[2].rgb.dtype == np.uint16
    np.testing.assert_array_equal(hyb[2].rgb,
                                  decode_bytes(items[2], device="cpu"))
    assert not hyb[-1].ok and "NativeDecodeError" in hyb[-1].error
    for h, g in zip(host, hyb):
        assert h.ok == g.ok and h.error == g.error
        if h.ok:
            np.testing.assert_array_equal(h.rgb, g.rgb)
    for g, data in zip([hyb[1], *hyb[3:-1]], [items[1], *items[3:-1]]):
        np.testing.assert_array_equal(
            g.rgb, decode_bytes(data, path="fast", device="cpu"))


def test_mixed_tables_claim_goes_to_host():
    """A claim whose images differ in Huffman tables is refused before
    launch and decoded on the host, bit-identically."""
    items = _corpus(12) + _corpus(2, optimize=True)
    dec = BatchedCorpusDecoder(workers=1, hybrid_device=True, device_batch=2,
                               device="cpu")
    got = dec.decode_all(items)
    host = BatchedCorpusDecoder(workers=1, device="cpu").decode_all(items)
    assert dec.fallback_frames >= 2
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g.rgb, h.rgb)


def test_device_failure_is_not_hidden(monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("simulated launch failure")

    monkeypatch.setattr(device_huffman, "decode_prepared_batch", boom)
    dec = BatchedCorpusDecoder(workers=2, hybrid_device=True, device_batch=2,
                               device="cpu")
    with pytest.raises(RuntimeError, match="simulated launch failure"):
        dec.decode_all(_corpus(12))


def test_hybrid_stress_many_threads():
    """More host workers than cores and a tiny switch interval: every item
    is decoded exactly once and no counter update is lost."""
    import sys
    import threading

    items = _corpus(24)
    want = BatchedCorpusDecoder(workers=2, device="cpu").decode_all(items)
    dec = BatchedCorpusDecoder(workers=2 * (os.cpu_count() or 1),
                               hybrid_device=True, device_batch=2,
                               device="cpu")
    box = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=lambda: box.update(r=dec.decode_all(items)))
        t.start()
        t.join(timeout=240)
    finally:
        sys.setswitchinterval(old)
        dec.close()
    assert not t.is_alive()
    assert dec.fallback_frames == 0
    assert dec.device_frames == 2 * dec.entropy_launches
    for g, w in zip(box["r"], want):
        np.testing.assert_array_equal(g.rgb, w.rgb)


def test_tail_guard_leaves_small_corpus_to_host():
    dec = BatchedCorpusDecoder(workers=2, hybrid_device=True, device_batch=4,
                               device="cpu")
    assert all(r.ok for r in dec.decode_all(_corpus(11)))
    assert dec.device_frames == 0 and dec.entropy_launches == 0


def _fast(data):
    return decode_bytes(data, path="fast", device="cpu")


@pytest.mark.parametrize("tables", ["shared", "per_frame"])
def test_staged_bucket_mixes_routes(tables):
    """One bucket of host, device (K3's twin) and fallback frames, plus a
    frame that becomes an error record, staged: each call equals the
    single-image decode in order. K3 takes a claim's frames in reverse
    order, so their slots run against the item order; with a quantisation
    table per frame, K1's tables must follow the slots. The first call
    makes the buffer (no frame had a slot), the second writes every frame
    straight into its slot."""
    qualities = [85] if tables == "shared" else [40, 60, 85, 95]
    frames = [encode_rgb(synthetic_image(96, 64, seed=i), subsampling=(2, 2),
                         restart_interval_mcus=3,
                         quality=qualities[i % len(qualities)])
              for i in range(14)]
    # The device thread claims from the back: the poisoned frame fails its
    # lane and goes back to the host route (fallback), its neighbour is K3's.
    items = frames[:12] + [_poisoned(frames[12]), frames[13]]
    dec = BatchedCorpusDecoder(workers=2, hybrid_device=True, device_batch=2,
                               device="cpu")
    for call in range(2):
        staged, launches = dec.staged_frames, dec.pixel_launches
        got = dec.decode_all(items)
        assert dec.pixel_launches - launches == 1  # one bucket
        assert dec.staged_frames - staged == (13 if call else 0)
        assert not got[12].ok and "NativeDecodeError" in got[12].error
        for g, data in zip(got[:12] + got[13:], items[:12] + items[13:]):
            np.testing.assert_array_equal(g.rgb, _fast(data))
        assert {"host", "device", "fallback"} <= set(dec.routes)
    assert dec.pinned_frames == 0  # no CUDA device: unpinned staging
    (buf,) = dec._staging.buffers.values()
    assert buf.capacity == 13 and not buf.pinned
    dec.close()
    assert dec._staging.buffers == {}


def test_staging_grows_and_results_stay_their_own():
    """Calls of 3, 6 and 2 frames of one geometry on one decoder: the buffer
    grows to 6 slots in the second call (its first 3 frames straight into
    their slots) and is reused by the third; no call's results share
    memory with another's or with the staging, and the first call's arrays
    are unchanged by the later calls."""
    corpus = _corpus(11)
    calls = [corpus[:3], corpus[3:9], corpus[9:]]
    dec = BatchedCorpusDecoder(workers=2, device="cpu")
    results, staged, buffers = [], [], []
    for items in calls:
        before = dec.staged_frames
        results.append(dec.decode_all(items))
        staged.append(dec.staged_frames - before)
        (buf,) = dec._staging.buffers.values()
        buffers.append(buf)
    first = [r.rgb.copy() for r in results[0]]
    assert staged == [0, 3, 2]
    assert [b.capacity for b in buffers] == [3, 6, 6]
    assert buffers[1] is buffers[2] and buffers[0] is not buffers[1]
    for items, res in zip(calls, results):
        for r, data in zip(res, items):
            np.testing.assert_array_equal(r.rgb, _fast(data))
            assert not np.shares_memory(r.rgb, buffers[2].base)
    for a, b in zip(results[0], results[1] + results[2]):
        assert not np.shares_memory(a.rgb, b.rgb)
    for r, want in zip(results[0], first):
        np.testing.assert_array_equal(r.rgb, want)


def test_a_second_concurrent_decode_all_raises(monkeypatch):
    """Staging slots belong to the call in progress: a call made while
    another runs on the same decoder raises, and the first is unharmed."""
    import threading

    from jpeg_tpu_torch.parallel import pipeline

    entered, gate = threading.Event(), threading.Event()
    parse = pipeline.parse_jpeg

    def held(data):
        entered.set()
        gate.wait(timeout=60)
        return parse(data)

    monkeypatch.setattr(pipeline, "parse_jpeg", held)
    items = _corpus(3)
    dec = BatchedCorpusDecoder(workers=1, device="cpu")
    box = {}
    t = threading.Thread(target=lambda: box.update(r=dec.decode_all(items)))
    t.start()
    try:
        assert entered.wait(timeout=60)
        with pytest.raises(RuntimeError, match="already running"):
            dec.decode_all(items)
    finally:
        gate.set()
        t.join(timeout=60)
    assert not t.is_alive()
    for got in (box["r"], dec.decode_all(items)):
        for g, data in zip(got, items):
            np.testing.assert_array_equal(g.rgb, _fast(data))
    dec.close()


@pytest.mark.parametrize("name", SMALL)
@pytest.mark.parametrize("rounding", ["truncate", "round"])
def test_decode_bytes_matches_jax_fast_path(name, rounding):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    got = decode_bytes(data, rounding=rounding, path="fast", device="cpu")
    _within_one(got, np.asarray(ref_decode_bytes(data, rounding=rounding,
                                                 path="fast")))


def test_decode_file_and_exif_orientation():
    from jpeg_tpu.models.decoder import apply_exif_orientation as ref_orient
    from jpeg_tpu_torch.models.decoder import apply_exif_orientation

    path = os.path.join(FIXTURES, SMALL[0])
    rgb = decode_file(path, device="cpu")
    assert rgb.shape == (384, 512, 3)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(rgb, decode_bytes(f.read(), device="cpu"))
    # the fixture has no EXIF block: orientation is a no-op
    np.testing.assert_array_equal(
        rgb, decode_file(path, device="cpu", exif_orientation=True))
    for orientation in range(1, 9):
        np.testing.assert_array_equal(apply_exif_orientation(rgb, orientation),
                                      ref_orient(rgb, orientation))


@pytest.mark.parametrize("kwargs,match", [
    (dict(path="fast", upsample="fancy"), "upsample='fancy'"),
    (dict(upsample="fancy"), "upsample='fancy'"),
    (dict(color_space="ycbcr"), "color_space='ycbcr'"),
    (dict(path="fast", idct_mode="approx"), "idct_mode='approx'"),
])
def test_off_slice_options_raise(kwargs, match):
    """The options the port once refused. Fancy upsampling and YCbCr output
    are ported: within +-1 u8 of the JAX package with the same options
    (which, as in the JAX package, ignores ``upsample`` on the fast path).
    ``idct_mode='approx'`` (K1a's twin) is within the docs/APPROX_QUALITY.md
    gate, max |diff| <= 2 u8 and >= 50 dB, of the JAX package's approx
    tier, which on the CPU is its exact tier."""
    data = _corpus(1)[0]
    if match.startswith("idct_mode"):
        got = decode_bytes(data, device="cpu", **kwargs)
        want = np.asarray(ref_decode_bytes(data, **kwargs))
        diff = np.abs(got.astype(float) - want.astype(float))
        assert got.shape == want.shape and diff.max() <= 2
        assert 10 * np.log10(255.0**2 / max((diff**2).mean(), 1e-12)) >= 50
        return
    _within_one(decode_bytes(data, device="cpu", **kwargs),
                np.asarray(ref_decode_bytes(data, **kwargs)))


def test_off_slice_streams_raise():
    """Progressive, arithmetic and (from ROADMAP item 3b) 12-bit streams,
    once refused, decode within +-1 of the JAX package on both paths."""
    img = synthetic_image(48, 32, seed=3)
    streams = {
        "progressive": encode_rgb_progressive(img, quality=85),
        "arithmetic": encode_rgb(img, quality=85, arithmetic=True),
        "progressive arithmetic": encode_rgb_progressive(img, quality=85,
                                                         arithmetic=True),
    }
    for what, data in streams.items():
        for path in ("compat", "fast"):
            _within_one(decode_bytes(data, path=path, device="cpu"),
                        np.asarray(ref_decode_bytes(data, path=path)))
    data = _twelve_bit()
    for path in ("compat", "fast"):
        got = decode_bytes(data, path=path, device="cpu")
        want = np.asarray(ref_decode_bytes(data, path=path))
        assert got.dtype == want.dtype == np.uint16
        diff = np.abs(got.astype(int) - want.astype(int))
        assert got.shape == want.shape and diff.max() <= 1


def _pool(dec):
    """The decoder's result buffers of its one geometry."""
    (pool,) = dec._staging.rgb.values()
    return pool


def _in_pool(results, pool) -> list[bool]:
    return [any(np.shares_memory(r.rgb, b.array) for b in pool)
            for r in results]


def test_held_results_survive_later_calls():
    """A caller that keeps every call's results: calls 0 and 1 come down
    into two result buffers, calls 2 to 4 into fresh memory (both buffers
    held), so no more than two buffers exist and every kept array is
    unchanged, byte for byte, after the later calls."""
    corpus = _corpus(15)
    calls = [corpus[3 * c : 3 * c + 3] for c in range(5)]
    dec = BatchedCorpusDecoder(workers=2, device="cpu")
    kept, copies = [], []
    for c, items in enumerate(calls):
        got = dec.decode_all(items)
        kept.append(got)
        copies.append([r.rgb.copy() for r in got])
        pool = _pool(dec)
        assert len(pool) == min(c + 1, 2)
        assert _in_pool(got, pool) == [c < 2] * len(items)
        assert all(b.held() for b in pool)
    for items, got, want in zip(calls, kept, copies):
        for r, data, w in zip(got, items, want):
            np.testing.assert_array_equal(r.rgb, w)
            np.testing.assert_array_equal(r.rgb, _fast(data))
    assert dec.pinned_rgb_frames == 0  # no CUDA device: unpinned buffers
    dec.close()
    assert dec._staging.rgb == {}
    for got, want in zip(kept, copies):  # still the caller's after close
        for r, w in zip(got, want):
            np.testing.assert_array_equal(r.rgb, w)


def test_result_buffer_reused_once_results_dropped():
    """One buffer while the caller drops each call's results (the
    benchmark's loop), two while it keeps one call's results through the
    next (the CLI's loop, which then alternates between them), and a free
    buffer too small for a call is replaced by one of the call's size. A
    view of a result, or a tensor made from one, holds the buffer too."""
    corpus = _corpus(17)
    dec = BatchedCorpusDecoder(workers=2, device="cpu")
    got = dec.decode_all(corpus[:3])
    (first,) = _pool(dec)
    del got
    assert not first.held()
    for items in (corpus[3:6], corpus[6:9]):
        got = dec.decode_all(items)
        assert _pool(dec) == [first] and _in_pool(got, [first]) == [True] * 3
        del got
    held = dec.decode_all(corpus[9:11])
    corner = torch.from_numpy(held[1].rgb[:4, :4])  # outlives the results
    del held
    assert first.held()
    got = dec.decode_all(corpus[11:13])  # first still held: a second buffer
    pool = _pool(dec)
    assert len(pool) == 2 and pool[0] is first
    assert _in_pool(got, [pool[1]]) == [True] * 2
    del corner
    # the second is held by `got`; first is free, but too small for 4
    bigger = dec.decode_all(corpus[13:17])
    pool = _pool(dec)
    assert len(pool) == 2 and first not in pool and first.array is None
    assert [b.capacity for b in pool] == [2, 4]
    assert _in_pool(bigger, [pool[1]]) == [True] * 4
    for r, data in zip(got + bigger, corpus[11:17]):
        np.testing.assert_array_equal(r.rgb, _fast(data))
    dec.close()


@pytest.mark.parametrize("hybrid", [False, True])
def test_pooled_results_equal_host_route(hybrid):
    """Results through reused buffers, with one call's results kept
    through the next, equal the host-only route's on a decoder that never
    reuses one (a fresh decoder a call), byte for byte."""
    corpus = _corpus(24)
    dec = BatchedCorpusDecoder(workers=2, hybrid_device=hybrid,
                               device_batch=2, device="cpu")
    prev = None
    for items in (corpus[:12], corpus[12:], corpus[:12]):
        got = dec.decode_all(items)
        ref = BatchedCorpusDecoder(workers=2, device="cpu")
        want = ref.decode_all(items)
        ref.close()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.rgb, w.rgb)
        if prev is not None:  # the call before, held through this one
            for g, w in zip(*prev):
                np.testing.assert_array_equal(g.rgb, w.rgb)
        prev = (got, want)
    if hybrid:
        assert dec.device_frames > 0
    assert len(_pool(dec)) == 2
    dec.close()
