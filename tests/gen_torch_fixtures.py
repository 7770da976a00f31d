"""Generate the committed JPEG fixtures that ``chip_smoke.py`` and the
``jpeg_tpu_torch`` tests decode.

The machine with the GPU has neither PIL nor an encoder the smoke could
call, so its inputs are committed. Run once (needs PIL/libjpeg) and commit
the output:

    python tests/gen_torch_fixtures.py

Each file is named after its generator arguments:
``synth_<W>x<H>_s<seed>_q<quality>_rst<restart rows>[_gray].jpg``.
"""

import io
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from PIL import Image  # noqa: E402

from jpeg_tpu.io.corpus import synthetic_image, synthetic_jpeg  # noqa: E402

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens", "torch")

# (width, height, seed, quality, restart rows, grayscale)
FIXTURES = [
    (3840, 2160, 0, 85, 1, False),
    (3840, 2160, 1, 85, 1, False),
    (512, 384, 2, 85, 1, False),
    (512, 384, 3, 85, 0, False),
    (512, 384, 4, 85, 1, True),
]


def fixture_name(width, height, seed, quality, restart_rows, gray) -> str:
    return (f"synth_{width}x{height}_s{seed}_q{quality}_rst{restart_rows}"
            f"{'_gray' if gray else ''}.jpg")


def _encode(width, height, seed, quality, restart_rows, gray) -> bytes:
    if not gray:
        return synthetic_jpeg(width, height, seed=seed, quality=quality,
                              restart_rows=restart_rows)
    buf = io.BytesIO()
    img = Image.fromarray(synthetic_image(width, height, seed)).convert("L")
    img.save(buf, "JPEG", quality=quality, restart_marker_rows=restart_rows)
    return buf.getvalue()


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    for args in FIXTURES:
        path = os.path.join(OUT_DIR, fixture_name(*args))
        data = _encode(*args)
        with open(path, "wb") as f:
            f.write(data)
        print(f"{path}: {len(data)} bytes")


if __name__ == "__main__":
    main()
