"""The compat route's colour models, fancy upsampling and YCbCr output in
jpeg_tpu_torch against jpeg_tpu's.

Streams: the committed CMYK (baseline and progressive), YCCK and RGB-direct
fixtures, seeded small streams at five chroma samplings, and PIL's own
decodes where ``tests/test_adobe_color.py`` holds the JAX package to them.
Pixels are within +-1 u8 of the JAX compat route with under 5% of values
differing (XLA may contract the colour products into fused multiply-adds);
run as a script, this file prints the shares:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_colour.py
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from jpeg_tpu.io.corpus import synthetic_image
from jpeg_tpu.models import decoder as ref_dec
from jpeg_tpu.models.encoder import encode_cmyk, encode_rgb
from jpeg_tpu.ops import color as ref_color
from jpeg_tpu.ops import upsample as ref_up
from jpeg_tpu_torch import decode_bytes
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.models import decoder as dec
from jpeg_tpu_torch.ops import color, upsample

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens", "torch")
COMPAT_ROUTE = {"cmyk": "synth_512x384_s8_q85_rst0_cmyk.jpg",
                "cmyk_prog": "synth_512x384_s9_q85_rst0_cmyk_prog.jpg",
                "ycck": "synth_512x384_s10_q85_rst0_ycck.jpg",
                "rgb": "synth_512x384_s11_q85_rst0_rgb.jpg"}
# The five samplings fancy upsampling is held on: luma (h, v) over 1x1
# chroma.
FANCY = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2), "4x1": (4, 1),
         "4x4": (4, 4)}


def _read(name) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _share_within_one(got, want) -> float:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    share = float((diff > 0).mean())
    assert share < 0.05
    return share


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _sampled(case: str) -> bytes:
    img = synthetic_image(150, 70, seed=len(case))
    return encode_rgb(img, quality=88, subsampling=FANCY[case])


@pytest.mark.parametrize("rounding", ["truncate", "round"])
@pytest.mark.parametrize("kind", COMPAT_ROUTE)
def test_colour_models_within_one_of_jax_compat(kind, rounding):
    data = _read(COMPAT_ROUTE[kind])
    assert parse_jpeg(data).color_model == kind.split("_")[0]
    got = decode_bytes(data, rounding=rounding, device="cpu")
    _share_within_one(got, np.asarray(ref_dec.decode_bytes(data,
                                                           rounding=rounding)))
    # The fast path sends these streams to the compat route.
    np.testing.assert_array_equal(
        got, decode_bytes(data, rounding=rounding, path="fast", device="cpu"))


@pytest.mark.parametrize("kind", ["cmyk", "cmyk_prog", "rgb"])
def test_pil_agrees_where_the_jax_package_is_held_to_it(kind):
    """tests/test_adobe_color.py's bar: rounding-only differences from
    libjpeg (through PIL) for Adobe CMYK and RGB-direct streams."""
    data = _read(COMPAT_ROUTE[kind])
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert _psnr(decode_bytes(data, rounding="round", device="cpu"), pil) > 55.0


def test_ycck_round_trip_from_the_jax_encoder():
    cmyk = np.asarray(Image.fromarray(synthetic_image(96, 64, seed=5))
                      .convert("CMYK"))
    data = encode_cmyk(cmyk, quality=95, ycck=True)
    assert parse_jpeg(data).color_model == "ycck"
    got = decode_bytes(data, rounding="round", device="cpu")
    _share_within_one(got, np.asarray(ref_dec.decode_bytes(data,
                                                           rounding="round")))
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert _psnr(got, pil) > 40.0


@pytest.mark.parametrize("case", FANCY)
def test_fancy_upsample_within_one_of_jax(case):
    data = _sampled(case)
    got = decode_bytes(data, upsample="fancy", device="cpu")
    _share_within_one(got, np.asarray(ref_dec.decode_bytes(data,
                                                           upsample="fancy")))
    assert not np.array_equal(got, decode_bytes(data, device="cpu"))


@pytest.mark.parametrize("case", FANCY)
def test_fancy_component_plane_equals_jax(case):
    """Assembly plus the triangular filter (two passes for 4x) on seeded
    blocks: the same float32 operations, equal values."""
    h_max, v_max = FANCY[case]
    mcus_y, mcus_x = 3, 5
    blocks = np.random.default_rng(h_max * 10 + v_max).normal(
        0, 50, (mcus_y * mcus_x, 8, 8)).astype(np.float32)
    height, width = mcus_y * v_max * 8 - 5, mcus_x * h_max * 8 - 3
    got = upsample.component_plane(torch.from_numpy(blocks), mcus_y, mcus_x,
                                   1, 1, v_max, h_max, height, width,
                                   upsample="fancy")
    want = ref_up.component_plane(blocks, mcus_y, mcus_x, 1, 1, v_max, h_max,
                                  height, width, upsample="fancy")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", [
    "synth_512x384_s2_q85_rst1.jpg", "synth_512x384_s4_q85_rst1_gray.jpg",
    COMPAT_ROUTE["cmyk"], COMPAT_ROUTE["ycck"],
    "synth_512x384_s7_q85_rst0_sof10.jpg"])
def test_ycbcr_output_within_one_of_jax(name):
    """color_space='ycbcr': level-shifted full-resolution planes, 3 channels
    (gray padded with 128) or 4 for CMYK and YCCK, on both paths."""
    data = _read(name)
    want = np.asarray(ref_dec.decode_bytes(data, color_space="ycbcr"))
    for path in ("compat", "fast"):
        got = decode_bytes(data, color_space="ycbcr", path=path, device="cpu")
        _share_within_one(got, want)
    n_comp = len(parse_jpeg(data).components)
    assert got.shape[-1] == (4 if n_comp == 4 else 3)
    if n_comp == 1:
        assert (got[..., 1:] == 128).all()


def _planes(seed, n, shape=(40, 56)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-160, 160, shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("rounding", ["truncate", "round"])
def test_colour_ops_within_one_of_jax(rounding):
    c, m, y, k = _planes(1, 4)
    t = [torch.from_numpy(p) for p in (c, m, y, k)]
    for ycck in (False, True):
        got = color.cmyk_to_rgb(*t, rounding=rounding, ycck=ycck)
        want = ref_color.cmyk_to_rgb(c, m, y, k, rounding, ycck=ycck)
        _share_within_one(got.permute(1, 2, 0).numpy(), np.asarray(want))
    got = color.rgb_direct(*t[:3], rounding=rounding)
    np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(),
                                  np.asarray(ref_color.rgb_direct(c, m, y,
                                                                  rounding)))
    np.testing.assert_array_equal(
        color.quantize_samples(t[0] + 128.0, rounding).numpy(),
        np.asarray(ref_color.quantize_samples(c + 128.0, rounding)))
    # 12-bit samples (maxval 4095): u16, equal to the JAX narrowing and
    # level shifts on planes spread over the 12-bit range.
    wide = [p * 16.0 for p in (c, m, y)]
    tw = [torch.from_numpy(p) for p in wide]
    got = color.quantize_samples(tw[0] + 2048.0, rounding, maxval=4095)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ref_color.quantize_samples(wide[0] + 2048.0, rounding, 4095)))
    np.testing.assert_array_equal(
        color.rgb_direct(*tw, rounding=rounding, maxval=4095)
        .permute(1, 2, 0).numpy(),
        np.asarray(ref_color.rgb_direct(*wide, rounding, 4095)))
    np.testing.assert_array_equal(
        color.grayscale_to_rgb(tw[0], rounding, 4095).permute(1, 2, 0).numpy(),
        np.asarray(ref_color.grayscale_to_rgb(wide[0], rounding, 4095)))
    got = color.ycbcr_to_rgb(*tw, rounding=rounding, maxval=4095)
    assert got.dtype == torch.uint16
    want = np.asarray(ref_color.ycbcr_to_rgb(*wide, rounding, 4095))
    assert want.dtype == np.uint16
    diff = np.abs(got.permute(1, 2, 0).numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05


def test_decode_plan_takes_upsample_and_color_space():
    data = _read(COMPAT_ROUTE["cmyk_prog"])
    plan = parse_jpeg(data)
    np.testing.assert_array_equal(
        dec.decode_plan(plan, upsample="fancy", color_space="ycbcr",
                        device="cpu"),
        decode_bytes(data, upsample="fancy", color_space="ycbcr",
                     device="cpu"))
    with pytest.raises(ValueError, match="color_space"):
        dec.decode_plan(plan, color_space="hsv", device="cpu")
    with pytest.raises(ValueError, match="upsample"):
        dec.decode_plan(plan, upsample="cubic", device="cpu")


if __name__ == "__main__":
    for kind, name in COMPAT_ROUTE.items():
        data = _read(name)
        share = _share_within_one(decode_bytes(data, device="cpu"),
                                  np.asarray(ref_dec.decode_bytes(data)))
        print(f"{kind}: share of values differing from jpeg_tpu's compat "
              f"decode {share:.3e}")
    for case in FANCY:
        data = _sampled(case)
        share = _share_within_one(
            decode_bytes(data, upsample="fancy", device="cpu"),
            np.asarray(ref_dec.decode_bytes(data, upsample="fancy")))
        print(f"fancy {case}: share differing {share:.3e}")
