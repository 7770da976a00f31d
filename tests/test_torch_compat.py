"""The compat decode (jpeg_tpu_torch's default route) against jpeg_tpu's.

``decode_bytes`` and ``decode_file`` default to the compat path in both
packages: host C++ entropy decode into zigzag blocks, one fp32 product per
component with the fused dequant + unzigzag + IDCT matrix, replicate
upsample, colour. Coefficients must be equal; pixels within +-1 u8 with
under 5% of them differing, the JAX package's own bar between its tiers
(tests/test_fast_path.py): the two products sum in another order (XLA's dot
against PyTorch's), so truncation may flip. Run as a script, this file
prints the share of differing pixels per case:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_compat.py
"""

import os

import numpy as np
import pytest
import torch

from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu.models import decoder as ref_dec
from jpeg_tpu.ops import upsample as ref_up
from jpeg_tpu.ops.idct import fused_idct_matrix as ref_fused_matrix
from jpeg_tpu_torch import decode_bytes, decode_file, encode_rgb
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.models import decoder as dec
from jpeg_tpu_torch.ops import upsample
from jpeg_tpu_torch.ops.idct import fused_idct_matrix

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens", "torch")
SMALL = ["synth_512x384_s2_q85_rst1.jpg", "synth_512x384_s3_q85_rst0.jpg",
         "synth_512x384_s4_q85_rst1_gray.jpg"]
FRAMES_4K = ["synth_3840x2160_s0_q85_rst1.jpg", "synth_3840x2160_s1_q85_rst1.jpg"]
# Every sampling the port decodes: luma (h, v) over 1x1 chroma, and gray.
SAMPLINGS = {"1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2),
             "4x1": (4, 1), "4x4": (4, 4), "gray": None}
CASES = [*SMALL, *FRAMES_4K, *SAMPLINGS]


def _image(width, height, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    img = np.stack([128 + 80 * np.sin(xx / 17.0 + seed) * np.cos(yy / 11.0),
                    128 + 80 * np.sin(xx / 9.0) * np.cos(yy / 23.0 + seed),
                    128 + 80 * np.cos(xx / 31.0 + yy / 7.0)], axis=-1)
    img += rng.normal(0, 6.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _stream(case: str) -> bytes:
    """A fixture, or a seeded 150x70 image encoded at one sampling (an odd
    size: the last MCUs are partly edge fill)."""
    if case.endswith(".jpg"):
        with open(os.path.join(FIXTURES, case), "rb") as f:
            return f.read()
    sub = SAMPLINGS[case]
    img = _image(150, 70, seed=len(case))
    if sub is None:
        return encode_rgb(img[..., 0], quality=88, grayscale=True,
                          restart_interval_mcus=3)
    return encode_rgb(img, quality=88, subsampling=sub, restart_interval_mcus=3)


def _share_within_one(got, want) -> float:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    share = float((diff > 0).mean())
    assert share < 0.05
    return share


@pytest.mark.parametrize("rounding", ["truncate", "round"])
@pytest.mark.parametrize("case", CASES)
def test_decode_bytes_default_within_one_of_jax(case, rounding):
    data = _stream(case)
    got = decode_bytes(data, rounding=rounding, device="cpu")
    _share_within_one(got, np.asarray(ref_dec.decode_bytes(data, rounding=rounding)))
    # The fast path (K1's twin) is within one of the same route.
    _share_within_one(got, decode_bytes(data, rounding=rounding, path="fast",
                                        device="cpu"))


@pytest.mark.parametrize("exif", [False, True])
@pytest.mark.parametrize("name", SMALL)
def test_decode_file_default_within_one_of_jax(name, exif):
    path = os.path.join(FIXTURES, name)
    got = decode_file(path, device="cpu", exif_orientation=exif)
    _share_within_one(got, ref_dec.decode_file(path, exif_orientation=exif))
    with open(path, "rb") as f:
        np.testing.assert_array_equal(got, decode_bytes(f.read(), device="cpu"))


@pytest.mark.parametrize("engine", ["auto", "native"])
@pytest.mark.parametrize("case", CASES)
def test_coefficients_equal_jax(case, engine):
    data = _stream(case)
    got = dec.decode_coefficients_host(parse_jpeg(data), engine).copy()
    want = ref_dec.decode_coefficients_host(ref_parse(data), engine)
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_plan_matrices_equal_jax(case):
    data = _stream(case)
    got = dec.plan_matrices(parse_jpeg(data))
    want = ref_dec.plan_matrices(ref_parse(data))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_fused_idct_matrix_equals_jax(seed):
    q = np.random.default_rng(seed).integers(1, 256, 64)
    for dtype in (np.float32, np.float64):
        got, want = fused_idct_matrix(q, dtype), ref_fused_matrix(q, dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("v,h,v_max,h_max", [(1, 1, 1, 1), (2, 2, 2, 2),
                                             (1, 1, 2, 2), (1, 1, 4, 1),
                                             (1, 1, 1, 4), (2, 1, 2, 2)])
def test_component_plane_equals_jax(v, h, v_max, h_max):
    mcus_y, mcus_x = 3, 5
    rng = np.random.default_rng(v * 10 + h)
    blocks = rng.normal(0, 50, (mcus_y * mcus_x * v * h, 8, 8)).astype(np.float32)
    height, width = mcus_y * v_max * 8 - 5, mcus_x * h_max * 8 - 3
    got = upsample.component_plane(torch.from_numpy(blocks), mcus_y, mcus_x, v,
                                   h, v_max, h_max, height, width)
    want = ref_up.component_plane(blocks, mcus_y, mcus_x, v, h, v_max, h_max,
                                  height, width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_off_slice_options_of_the_compat_route_raise():
    """``engine='oracle'``, once refused, runs the NumPy reference decoder:
    the same coefficients and pixels as the native engine. Fancy
    upsampling, once refused, equals the JAX package's (exactly on
    assembled planes, +-1 u8 on pixels)."""
    data = _stream("2x2")
    plan = parse_jpeg(data)
    np.testing.assert_array_equal(
        decode_bytes(data, engine="oracle", device="cpu"),
        decode_bytes(data, engine="native", device="cpu"))
    np.testing.assert_array_equal(dec.decode_coefficients_host(plan, "oracle"),
                                  dec.decode_coefficients_host(plan, "native"))
    got = dec.decode_plan(plan, upsample="fancy", device="cpu")
    want = np.asarray(ref_dec.decode_plan(ref_parse(data), upsample="fancy"))
    _share_within_one(got, want)
    blocks = np.random.default_rng(5).normal(0, 40, (1, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        upsample.component_plane(torch.from_numpy(blocks), 1, 1, 1, 1, 2, 2,
                                 16, 16, upsample="fancy").numpy(),
        np.asarray(ref_up.component_plane(blocks, 1, 1, 1, 1, 2, 2, 16, 16,
                                          upsample="fancy")))
    with pytest.raises(ValueError, match="engine"):
        decode_bytes(data, engine="gpu", device="cpu")
    with pytest.raises(ValueError, match="path"):
        decode_bytes(data, path="slow", device="cpu")


def test_compat_route_refuses_tf32():
    """The fused matrix needs full fp32 products; TF32 is a global setting,
    so the route refuses it rather than flipping it."""
    data = _stream("1x1")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(ValueError, match="allow_tf32"):
            decode_bytes(data, device="cpu")
        # The fast path has no product and is not affected.
        decode_bytes(data, path="fast", device="cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


if __name__ == "__main__":
    for case in CASES:
        data = _stream(case)
        for rounding in ("truncate", "round"):
            got = decode_bytes(data, rounding=rounding, device="cpu")
            share = _share_within_one(
                got, np.asarray(ref_dec.decode_bytes(data, rounding=rounding)))
            print(f"{case} {rounding}: {got.shape[1]}x{got.shape[0]}, share of "
                  f"pixel values differing from jpeg_tpu's compat decode "
                  f"{share:.3e}")
