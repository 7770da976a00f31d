"""The encode route's layout of K2's input on the card
(``models/encoder.py``): :func:`planar_layout` makes, from a frame where it
lies, the edge-padded planar array that :func:`device_inputs` makes on the
host; on the card ``encode_rgb_device`` (the frame uploaded as it stands
and laid out there) writes the bytes of K2 on ``device_inputs``' array
followed by ``pack_planes_device``.

Imports no JAX: the ``cuda`` tests run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_encode_layout.py
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from jpeg_tpu_torch import encode_rgb_device
from jpeg_tpu_torch.models import encoder
from jpeg_tpu_torch.parallel.batch import encode_batch_device

# name -> (width, height, chroma subsampling; None for a gray [H, W] frame)
CASES = {
    "uhd_420": (3840, 2160, (2, 2)),
    "odd_420": (1917, 1081, (2, 2)),
    "tiny_420": (33, 17, (2, 2)),
    "gray": (1917, 1081, None),
    "odd_422": (1917, 1081, (2, 1)),
    "odd_444": (1917, 1081, (1, 1)),
    "crop_420": (1917, 1081, (2, 2)),  # a view into a larger frame
}


def _frame(name: str) -> np.ndarray:
    """Seeded u8 samples: smooth fields plus noise, so the scan is a
    photo's size; ``crop_420`` is a non-contiguous view."""
    width, height, sub = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    pad = 40 if name.startswith("crop") else 0
    yy, xx = np.mgrid[0:height + pad, 0:width + pad].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / (23.0 + 7 * c) + c)
                    * np.cos(yy / (13.0 + 5 * c)) for c in range(3)], -1)
    img = np.clip(img + rng.normal(0, 8.0, img.shape), 0, 255).astype(np.uint8)
    if pad:
        img = img[pad // 2:pad // 2 + height, pad // 4:pad // 4 + width]
        assert not img.flags.c_contiguous
    return img[..., 1] if sub is None else img


def _options(name: str) -> dict:
    sub = CASES[name][2]
    return dict(quality=85, subsampling=sub or (1, 1), grayscale=sub is None)


@pytest.mark.parametrize("name", CASES)
def test_layout_equals_device_inputs(name):
    img = _frame(name)
    geom, planar, _, _ = encoder.device_inputs(img, **_options(name))
    got = encoder.planar_layout(torch.from_numpy(img), geom)
    assert got.is_contiguous()
    assert torch.equal(got, torch.from_numpy(planar))


def test_upload_takes_any_u8_frame():
    """Strided, reversed and read-only frames go up with their samples as
    they are, and without a warning; other samples than u8 are refused."""
    img = _frame("tiny_420")
    frozen = img.copy()
    frozen.flags.writeable = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for x in (img, img[:, ::-1], img[::2], img[..., 1], frozen):
            assert np.array_equal(encoder.upload_frame(x, "cpu").numpy(), x)
    with pytest.raises(ValueError, match="uint8"):
        encoder.upload_frame(img.astype(np.float32), "cpu")


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("restart", ["none", "row"])
@pytest.mark.parametrize("name", CASES)
def test_card_bytes_equal_the_host_layouts(cuda, name, restart):
    """The frame uploaded as it stands and laid out on the card gives the
    host pad's array there, and the parent route's bytes: K2 on
    ``device_inputs``' array, then ``pack_planes_device``."""
    img = _frame(name)
    geom, planar, iq, quant_zz = encoder.device_inputs(img, **_options(name))
    r = 0 if restart == "none" else geom.mcus_x
    on_card = encoder.planar_layout(encoder.upload_frame(img, cuda), geom)
    assert torch.equal(on_card.cpu(), torch.from_numpy(planar))
    k2 = encode_batch_device(planar[None], iq[None], geom, device=cuda)
    want = encoder.pack_planes_device([p[0] for p in k2], geom, quant_zz, r)
    got = encode_rgb_device(img, restart_interval_mcus=r, device=cuda,
                            **_options(name))
    assert got == want
