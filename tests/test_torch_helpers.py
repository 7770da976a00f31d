"""The last public helpers of jpeg_tpu with a counterpart in
jpeg_tpu_torch, each against its original: ``runtime.native_available``
and ``runtime.plane_shapes``, ``ops.color.ycbcr_to_rgb_matrix``, the
direct-formula transforms ``ops.idct.idct_block_naive`` and
``dct_block_naive``, and ``entropy.tables.value_correction_np``."""

import numpy as np
import pytest

from jpeg_tpu import runtime as ref_rt
from jpeg_tpu.entropy import tables as ref_tables
from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu.models.encoder import encode_rgb
from jpeg_tpu.ops import color as ref_color
from jpeg_tpu.ops import idct as ref_idct
from jpeg_tpu_torch import runtime
from jpeg_tpu_torch.entropy import tables
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.ops import color, idct


def test_native_available():
    assert runtime.native_available() is True
    assert ref_rt.native_available() is True


@pytest.mark.parametrize("sub,size", [((1, 1), (37, 45)), ((2, 2), (250, 300)),
                                      ((2, 1), (130, 70)), ((1, 2), (64, 64)),
                                      (None, (300, 9))])
def test_plane_shapes(sub, size):
    img = np.random.default_rng(1).integers(0, 256, size + (3,), dtype=np.uint8)
    data = (encode_rgb(img[..., 0], quality=80, grayscale=True) if sub is None
            else encode_rgb(img, quality=80, subsampling=sub))
    plan = parse_jpeg(data)
    assert runtime.plane_shapes(plan) == ref_rt.plane_shapes(ref_parse(data))
    assert [p.shape for p in runtime.native_decode_planes(plan)] == \
        runtime.plane_shapes(plan)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ycbcr_to_rgb_matrix(dtype):
    got = color.ycbcr_to_rgb_matrix(dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, ref_color.ycbcr_to_rgb_matrix(dtype))


def test_naive_transforms():
    rng = np.random.default_rng(2)
    for _ in range(3):
        block = rng.integers(-512, 512, 64).astype(np.float32)
        pixels = rng.integers(-128, 128, 64).astype(np.float32)
        np.testing.assert_array_equal(idct.idct_block_naive(block),
                                      ref_idct.idct_block_naive(block))
        np.testing.assert_array_equal(idct.dct_block_naive(pixels),
                                      ref_idct.dct_block_naive(pixels))
    # The two are inverse up to float32 rounding.
    np.testing.assert_allclose(idct.idct_block_naive(idct.dct_block_naive(
        pixels)), pixels, atol=1e-3)


def test_value_correction_np():
    nbits = np.repeat(np.arange(16), 64)
    vals = np.random.default_rng(3).integers(0, 1 << 16, nbits.size) & (
        (1 << nbits) - 1)
    got = tables.value_correction_np(vals, nbits)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref_tables.value_correction_np(vals, nbits))
    np.testing.assert_array_equal(
        got, [tables.value_correction(int(v), int(n)) for v, n in zip(vals, nbits)])
