"""The plain reference against the program's CPU routes on small frames:
its coefficients equal the C++ runtime's, its pixels the fast path's but
for truncation ties, its forward transform K2's twin's but for
quantisation ties."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import jpeg as ref


def small_streams():
    from jpeg_tpu_torch.io.corpus import synthetic_image
    from jpeg_tpu_torch.models.encoder import encode_rgb

    out = []
    for i, (w, h, sub, rst) in enumerate(((64, 48, (2, 2), 4), (80, 40, (2, 2), 5),
                                          (48, 32, (1, 1), 6), (72, 56, (2, 1), 0))):
        img = synthetic_image(w, h, 20 + i)
        out.append((img, encode_rgb(img, quality=85, subsampling=sub,
                                    restart_interval_mcus=rst)))
    return out


def test_coefficients_equal_runtime():
    from jpeg_tpu_torch import runtime
    from jpeg_tpu_torch.io.container import parse_jpeg

    for _, data in small_streams():
        fr = ref.parse(data)
        coeffs = ref.Decoder().coefficients(fr)
        planes = runtime.native_decode_planes(parse_jpeg(data), n_threads=1)
        for c, p in zip(coeffs, planes):
            r, k = c.shape[:2]
            mine = c.reshape(r, k, 8, 8).transpose(0, 2, 1, 3).reshape(r * 8, k * 8)
            assert np.array_equal(mine, p[:r * 8, :k * 8])


def test_pixels_match_fast_path():
    from jpeg_tpu_torch.parallel.pipeline import BatchedCorpusDecoder

    streams = [d for _, d in small_streams()]
    got = BatchedCorpusDecoder(device="cpu", workers=2).decode_all(streams)
    for data, res in zip(streams, got):
        fr = ref.parse(data)
        want = ref.pixels(fr, ref.Decoder().coefficients(fr)).numpy()
        diff = np.abs(want.astype(np.int16) - res.rgb.astype(np.int16))
        assert diff.max() <= 1 and (diff != 0).mean() < 1e-3


def test_forward_matches_device_encode():
    from jpeg_tpu_torch import encode_rgb_device

    for img, _ in small_streams()[:2]:
        data = encode_rgb_device(img, quality=85, restart_interval_mcus=4,
                                 device="cpu")
        got = ref.Decoder().coefficients(ref.parse(data))
        want = ref.forward(img, 85, (2, 2))
        n = sum(w.numel() for w in want)
        differ = sum((torch.from_numpy(g) != w).sum().item()
                     for g, w in zip(got, want))
        assert differ / n < 1e-4


def test_decoder_memo_and_errors():
    _, data = small_streams()[0]
    fr = ref.parse(data)
    dec = ref.Decoder()
    a = dec.coefficients(fr)
    b = dec.coefficients(fr)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    bad = bytearray(data)
    start = bytes(data).index(b"\xff\xda") + 14
    bad[start:start + 8] = b"\xff\x00" * 4  # 32 one bits: no DC code
    with pytest.raises(ValueError):
        ref.Decoder().coefficients(ref.parse(bytes(bad)))
    with pytest.raises(ValueError):
        ref.parse(b"\x00\x00")
