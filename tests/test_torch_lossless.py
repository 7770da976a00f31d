"""Lossless JPEG (SOF3) in jpeg_tpu_torch against jpeg_tpu, bit for bit:
the difference decoder, the three reconstructions (sequential, C++,
``torch.cumsum`` on the CPU), ``decode_bytes`` and the encoder's bytes,
over predictors 1-7, with and without restart intervals and point
transform, gray and three components, at precisions 8, 12 and 16.
Streams come from the JAX package's encoder on seeded NumPy samples."""

import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu import runtime as ref_rt
from jpeg_tpu.entropy import lossless as ref_ll
from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu_torch import decode_bytes, runtime
from jpeg_tpu_torch.entropy import lossless
from jpeg_tpu_torch.io.container import JPEGError, parse_jpeg

# (channels, precision, point transform, restart interval in samples)
CONFIGS = [(1, 8, 0, 0), (3, 12, 2, 7), (3, 16, 0, 0), (1, 16, 3, 23),
           (3, 8, 1, 40)]


def _samples(seed, channels, precision, shape=(20, 24)):
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if precision == 8 else np.uint16
    # A smooth ramp plus noise: realistic differences, every category used.
    ramp = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 3
    img = ramp[..., None] * (1 << (precision - 8)) + rng.integers(
        0, 1 << (precision - 3), (*shape, channels))
    img = np.clip(img, 0, (1 << precision) - 1).astype(dtype)
    return img[..., 0] if channels == 1 else img


def _stream(predictor, config, seed=0):
    channels, precision, pt, ri = config
    img = _samples(seed + predictor, channels, precision)
    kw = dict(predictor=predictor, point_transform=pt, precision=precision,
              restart_interval=ri)
    data = ref_ll.encode_lossless(img, **kw)
    return img, data, kw


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("predictor", range(1, 8))
def test_decode_and_encode_match_jax(predictor, config):
    img, data, kw = _stream(predictor, config)
    assert lossless.encode_lossless(img, **kw) == data
    ref, plan = ref_parse(data), parse_jpeg(data)
    diffs = lossless.decode_diffs(plan)
    np.testing.assert_array_equal(diffs, ref_ll.decode_diffs(ref))
    want = ref_ll.reconstruct(ref, ref_ll.decode_diffs(ref))
    assert want.dtype == np.uint16
    np.testing.assert_array_equal(lossless.reconstruct(plan, diffs), want)
    np.testing.assert_array_equal(runtime.native_decode_lossless(plan), want)
    np.testing.assert_array_equal(ref_rt.native_decode_lossless(ref), want)
    for engine in ("auto", "native", "oracle"):
        for device in (None, "cpu"):
            got = lossless.decode_lossless(plan, device=device, engine=engine)
            assert got.dtype == np.uint16
            np.testing.assert_array_equal(got, want)
    dev = lossless.reconstruct_device(plan, diffs, device="cpu")
    ref_dev = ref_ll.reconstruct_device(ref, ref_ll.decode_diffs(ref))
    assert (dev is None) == (ref_dev is None) == (
        not lossless.cumsum_takes(plan))
    if dev is not None:
        assert dev.dtype == torch.uint16
        np.testing.assert_array_equal(dev.numpy(), np.asarray(ref_dev))
        np.testing.assert_array_equal(dev.numpy(), want)
    # The pixels: samples as stored, gray replicated, u8 up to 8 bits.
    got = decode_bytes(data, device="cpu")
    ref_px = np.asarray(jpeg_tpu.decode_bytes(data))
    assert got.dtype == ref_px.dtype and got.shape == ref_px.shape
    np.testing.assert_array_equal(got, ref_px)
    np.testing.assert_array_equal(
        decode_bytes(data, path="fast", device="cpu"), ref_px)
    expect = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
    np.testing.assert_array_equal(got, (expect >> kw["point_transform"])
                                  << kw["point_transform"])


@pytest.mark.parametrize("channels,precision", [(1, 8), (3, 12), (3, 16)])
def test_auto_predictor_matches_jax(channels, precision):
    img = _samples(5, channels, precision, shape=(32, 28))
    data = lossless.encode_lossless(img, predictor="auto",
                                    precision=precision)
    assert data == ref_ll.encode_lossless(img, predictor="auto",
                                          precision=precision)
    np.testing.assert_array_equal(
        lossless.decode_lossless(parse_jpeg(data), device="cpu"),
        img.reshape(*img.shape[:2], -1))


@pytest.mark.parametrize("predictor", [1, 2])
def test_prediction_differences_invert_through_cumsum(predictor):
    """The smoke's 4K input, at a small size: differences made in NumPy by
    the encoder's prediction maps reconstruct to the image exactly."""
    img = _samples(9, 3, 8, shape=(17, 30))
    data = lossless.encode_lossless(img, predictor=predictor)
    plan = parse_jpeg(data)
    diffs = lossless.prediction_differences(img.astype(np.int32), predictor,
                                            128)
    np.testing.assert_array_equal(diffs.reshape(img.shape),
                                  np.asarray(lossless.decode_diffs(plan))
                                  & 0xFFFF)
    got = lossless.reconstruct_device(plan, diffs.reshape(img.shape), "cpu")
    np.testing.assert_array_equal(got.numpy(), img)


def test_cumsum_wraps_at_sixteen_bits_with_point_transform():
    """Sums past 2^16 wrap, and the shift by Pt wraps at 16 bits too."""
    img = np.full((4, 6), 65535 >> 2, np.uint16)
    img[::2, ::3] = 0
    data = ref_ll.encode_lossless(img, predictor=1, point_transform=2,
                                  precision=16)
    plan, ref = parse_jpeg(data), ref_parse(data)
    diffs = lossless.decode_diffs(plan) + 65536 * 3  # same mod 2^16
    got = lossless.reconstruct_device(plan, diffs, "cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_ll.reconstruct_device(
        ref, ref_ll.decode_diffs(ref))))
    np.testing.assert_array_equal(got[..., 0], (img >> 2) << 2)


def test_refusals():
    img = _samples(1, 1, 8)
    with pytest.raises(JPEGError, match="SOF3"):
        lossless.decode_lossless(parse_jpeg(jpeg_tpu.models.encoder.encode_rgb(
            np.stack([img] * 3, -1))), device="cpu")
    plan = parse_jpeg(ref_ll.encode_lossless(img))
    with pytest.raises(ValueError, match="engine"):
        lossless.decode_lossless(plan, device=None, engine="gpu")
    for kw in (dict(predictor=8), dict(precision=1), dict(point_transform=8)):
        with pytest.raises(ValueError):
            lossless.encode_lossless(img, **kw)
        with pytest.raises(ValueError):
            ref_ll.encode_lossless(img, **kw)
    bad = bytearray(ref_ll.encode_lossless(img, restart_interval=40))
    bad[-60:-20] = b"\xff\x00" * 20  # runs of ones: invalid prefixes
    with pytest.raises(runtime.NativeDecodeError):
        runtime.native_decode_lossless(parse_jpeg(bytes(bad)))
    with pytest.raises(ref_rt.NativeDecodeError):
        ref_rt.native_decode_lossless(ref_parse(bytes(bad)))


@pytest.mark.parametrize("predictor", [1, 2, 5])
def test_bare_call_takes_the_cpp_route(predictor, monkeypatch):
    """``decode_lossless(plan)`` defaults to the card (``device="cuda"``,
    the JAX package's ``device=True``) and decodes the differences there in
    C++ (``jt_decode_lossless_diffs``), never with the pure-Python
    :func:`decode_diffs`; scans the cumsum does not take go to
    ``jt_decode_lossless``. The same call with a CPU device (a bare call's
    route, without the card) equals the JAX default's samples, and
    ``decode_plan`` with a device takes the cumsum route where it applies,
    as the JAX ``decode_plan`` does."""
    import inspect

    from jpeg_tpu_torch.models.decoder import decode_plan

    sig = inspect.signature(lossless.decode_lossless).parameters
    assert sig["device"].default == "cuda" and sig["engine"].default == "auto"
    img, data, _kw = _stream(predictor, (3, 8, 0, 0))
    plan = parse_jpeg(data)
    want = np.asarray(ref_ll.decode_lossless(ref_parse(data)))

    def refuse(*_a, **_k):
        raise AssertionError("the Python difference decoder ran")

    routes = []
    real = lossless.reconstruct_device
    monkeypatch.setattr(lossless, "decode_diffs", refuse)
    monkeypatch.setattr(lossless, "reconstruct_device",
                        lambda *a: routes.append(1) or real(*a))
    got = lossless.decode_lossless(plan, device="cpu")
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(decode_plan(plan, device="cpu"), img)
    assert lossless.cumsum_takes(plan) == (predictor in (1, 2))
    assert routes == ([1, 1] if lossless.cumsum_takes(plan) else [])


@pytest.mark.parametrize("config", CONFIGS)
def test_native_differences_match_decode_diffs(config):
    """``native_decode_lossless_diffs`` (C++ phase 1) equals the JAX
    ``decode_diffs`` mod 2^16 for every predictor, with and without restart
    intervals, and feeds ``reconstruct_device`` to the same samples as the
    Python differences."""
    for predictor in range(1, 8):
        _img, data, _kw = _stream(predictor, config)
        plan, ref = parse_jpeg(data), ref_parse(data)
        got = runtime.native_decode_lossless_diffs(plan)
        want = np.asarray(ref_ll.decode_diffs(ref))
        assert got.dtype == np.uint16 and got.shape == want.shape
        np.testing.assert_array_equal(got, want & 0xFFFF)
        np.testing.assert_array_equal(
            runtime.native_decode_lossless_diffs(plan, n_threads=1), got)
        if lossless.cumsum_takes(plan):
            np.testing.assert_array_equal(
                lossless.reconstruct_device(plan, got, "cpu").numpy(),
                lossless.reconstruct_device(plan, want, "cpu").numpy())


def test_native_differences_refuse_an_invalid_prefix():
    """An invalid prefix raises, as in ``jt_decode_lossless``."""
    bad = bytearray(ref_ll.encode_lossless(_samples(1, 1, 8),
                                           restart_interval=40))
    bad[-60:-20] = b"\xff\x00" * 20  # runs of ones: invalid prefixes
    with pytest.raises(runtime.NativeDecodeError):
        runtime.native_decode_lossless_diffs(parse_jpeg(bytes(bad)))
