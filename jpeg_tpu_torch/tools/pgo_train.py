"""Training child of the C++ runtime's profile-guided build: the port's
counterpart of the repo-root ``tools/pgo_train.py``.

    python -m jpeg_tpu_torch.tools.pgo_train <instrumented libjpegtpu .so>

``jpeg_tpu_torch.utils.build`` runs it with the INSTRUMENTED build's path
and rebuilds with ``-fprofile-use`` from the counters it leaves at exit. It
makes the loaded runtime that library (``build.use_library``), so nothing
here builds the runtime again, then decodes representative streams through
it so that the rebuild learns their branch mix:

- the JAX tool's three, made by the port's encoder (which writes the JAX
  encoder's bytes): a 1920x1080 q85 4:2:0 frame of seeded noise with a
  smooth half, with a restart every 120 MCUs and without restarts (the
  speculative decode), and its gray luma;
- libjpeg-convention streams, whose tables differ from the port's encoder's:
  where the JAX tool writes them with PIL, the committed libjpeg streams
  (:data:`STREAMS`: the 4K progressive golden and the fuzz's libjpeg
  streams), as the card's machine has no PIL;
- the arithmetic (SOF9) 512x512 crop with a restart every 8 MCUs, and the
  progressive paths, Huffman and arithmetic.

Exits 0 when every decode ran. Its source and :data:`STREAMS` are hashed
into the runtime library's name, so editing either rebuilds it.
"""

from __future__ import annotations

import os
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The committed libjpeg streams it trains on (read, never written).
STREAMS = (
    os.path.join(os.path.dirname(_PKG), "tests", "goldens", "torch",
                 "synth_3840x2160_s5_q85_rst0_prog.jpg"),
    *(os.path.join(_PKG, "tools", "fuzz_streams", f"{n}.jpg")
      for n in ("pil", "pil_opt", "pil_prog", "pil_cmyk", "pil_cmyk_prog")),
)
REPS = 3


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m jpeg_tpu_torch.tools.pgo_train <instrumented "
              ".so>", file=sys.stderr)
        return 2
    import numpy as np

    from jpeg_tpu_torch import runtime as rt
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.models.encoder import encode_rgb, encode_rgb_progressive
    from jpeg_tpu_torch.utils import build

    build.use_library(rt.library_name(), argv[0], rt._configure)

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    img[:, :960] = img[:, 960:961]  # a smooth half: EOB / pair-hit mixes
    ours = [
        encode_rgb(img, quality=85, subsampling=(2, 2),
                   restart_interval_mcus=120),
        encode_rgb(img, quality=85, subsampling=(2, 2)),
        encode_rgb(img[..., 0], quality=85),
    ]
    libjpeg = []
    for path in STREAMS:
        with open(path, "rb") as f:
            libjpeg.append(parse_jpeg(f.read()))
    plans = [parse_jpeg(d) for d in ours] + libjpeg
    for plan in (p for p in plans if not p.progressive):
        for _ in range(REPS):
            rt.native_decode_planes(plan)
            rt.native_decode_coefficients(plan)

    crop = img[:512, :512]
    aplan = parse_jpeg(encode_rgb(crop, quality=85, arithmetic=True,
                                  restart_interval_mcus=8))
    for _ in range(REPS):
        rt.native_decode_arith_planes(aplan)
    progressive = [p for p in plans if p.progressive] + [parse_jpeg(
        encode_rgb_progressive(crop, quality=85, arithmetic=True))]
    for plan in progressive:
        for _ in range(REPS):
            rt.native_decode_progressive(plan, reuse_buffer=True)
    print(f"pgo_train: {len(plans) + 2} streams "
          f"x {REPS} decodes through {argv[0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
