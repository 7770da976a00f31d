"""Generate the committed JPEG fixtures that ``chip_smoke.py`` and the
``jpeg_tpu_torch`` tests decode.

The machine with the GPU has neither PIL nor an encoder the smoke could
call, so its inputs are committed. Run once (needs PIL/libjpeg) and commit
the output:

    python tests/gen_torch_fixtures.py

Each file is named after its generator arguments:
``synth_<W>x<H>_s<seed>_q<quality>_rst<restart rows>[_<kind>].jpg``, where
``kind`` names the stream when it is not a baseline Huffman YCbCr one:

- ``gray``: PIL (libjpeg) grayscale;
- ``prog``, ``gray_prog``: PIL progressive, YCbCr 4:2:0 or grayscale;
- ``sof9``: the JAX package's encoder, sequential arithmetic, 4:2:0;
- ``sof10``: the JAX package's encoder, progressive arithmetic, 4:2:0;
- ``cmyk``, ``cmyk_prog``: PIL ``convert("CMYK")`` (Adobe, inverted ink),
  baseline or progressive;
- ``ycck``: the JAX package's ``encode_cmyk(ycck=True)``;
- ``rgb``: PIL ``keep_rgb=True`` (RGB-direct, no colour transform).

A file that exists is kept as it is: only missing fixtures are written, so
the committed bytes never change under a newer PIL.
"""

import io
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from jpeg_tpu.io.corpus import synthetic_image, synthetic_jpeg  # noqa: E402
from jpeg_tpu.models.encoder import (  # noqa: E402
    encode_cmyk,
    encode_rgb,
    encode_rgb_progressive,
)

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens", "torch")

# (width, height, seed, quality, restart rows, kind); kind "" is baseline
# Huffman YCbCr 4:2:0 through synthetic_jpeg.
FIXTURES = [
    (3840, 2160, 0, 85, 1, ""),
    (3840, 2160, 1, 85, 1, ""),
    (512, 384, 2, 85, 1, ""),
    (512, 384, 3, 85, 0, ""),
    (512, 384, 4, 85, 1, "gray"),
    # Every other 8-bit DCT stream the decoders take.
    (3840, 2160, 5, 85, 0, "prog"),
    (3840, 2160, 6, 85, 1, "sof9"),
    (512, 384, 7, 85, 0, "sof10"),
    (512, 384, 8, 85, 0, "cmyk"),
    (512, 384, 9, 85, 0, "cmyk_prog"),
    (512, 384, 10, 85, 0, "ycck"),
    (512, 384, 11, 85, 0, "rgb"),
    (512, 384, 12, 85, 0, "gray_prog"),
]


def fixture_name(width, height, seed, quality, restart_rows, kind) -> str:
    return (f"synth_{width}x{height}_s{seed}_q{quality}_rst{restart_rows}"
            f"{'_' + kind if kind else ''}.jpg")


def _pil(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _encode(width, height, seed, quality, restart_rows, kind) -> bytes:
    if not kind:
        return synthetic_jpeg(width, height, seed=seed, quality=quality,
                              restart_rows=restart_rows)
    rgb = synthetic_image(width, height, seed)
    img = Image.fromarray(rgb)
    # MCUs per restart interval for the JAX package's encoder (4:2:0 MCUs
    # are 16 pixels wide).
    mcus = restart_rows * -(-width // 16)
    if kind == "gray":
        return _pil(img.convert("L"), quality=quality,
                    restart_marker_rows=restart_rows)
    if kind == "gray_prog":
        return _pil(img.convert("L"), quality=quality, progressive=True)
    if kind == "prog":
        return _pil(img, quality=quality, subsampling=2, progressive=True)
    if kind == "sof9":
        return encode_rgb(rgb, quality=quality, subsampling=(2, 2),
                          arithmetic=True, restart_interval_mcus=mcus)
    if kind == "sof10":
        return encode_rgb_progressive(rgb, quality=quality,
                                      subsampling=(2, 2), arithmetic=True)
    if kind in ("cmyk", "cmyk_prog"):
        return _pil(img.convert("CMYK"), quality=quality,
                    progressive=kind == "cmyk_prog")
    if kind == "ycck":
        return encode_cmyk(np.asarray(img.convert("CMYK")), quality=quality,
                           ycck=True)
    if kind == "rgb":
        return _pil(img, quality=quality, keep_rgb=True)
    raise ValueError(f"unknown fixture kind {kind!r}")


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    for args in FIXTURES:
        path = os.path.join(OUT_DIR, fixture_name(*args))
        if os.path.exists(path):
            print(f"{path}: kept")
            continue
        data = _encode(*args)
        with open(path, "wb") as f:
            f.write(data)
        print(f"{path}: {len(data)} bytes")


if __name__ == "__main__":
    main()
