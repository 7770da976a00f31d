"""The whole slice: jpeg_tpu_torch's corpus decoder and single-image entry
points against jpeg_tpu's, the hybrid route against the host route, error
isolation, and the rule that nothing but a lane error, an ineligible plan or
a table mismatch sends a claimed image back to the host."""

import os

import numpy as np
import pytest

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
