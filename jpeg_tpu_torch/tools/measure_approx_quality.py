"""The approx IDCT tier's quality gate on the card: the port's counterpart of
the repo-root ``tools/measure_approx_quality.py``.

    python -m jpeg_tpu_torch.tools.measure_approx_quality [--device cuda|cpu]
        [--reference DIR]

Every stream of the corpus matrix is decoded on the fast path twice,
``idct_mode="exact"`` (K1) and ``idct_mode="approx"`` (K1a, bf16
``mma.sync`` on the tensor cores), and the tool prints a markdown row each
with max |diff| (u8) and the PSNR between the two, then the worst case.
The gate is the JAX tool's (``docs/APPROX_QUALITY.md``): max |diff| <= 2
and PSNR >= 50 dB; a miss exits 1.

The synthetic cases keep the JAX tool's names, sizes, qualities and
samplings. The card's machine has no Pillow, so each is the port's
``encode_rgb`` of ``synthetic_image`` (the JAX tool encodes them with
libjpeg): 4K q70, q85 and q95 (seed 0) and 1080p q85 (seed 1), 4:2:0 with
a restart interval a MCU row, as libjpeg's ``restart_marker_rows=1``;
grayscale 1080p q90 (seed 1's luma by Pillow's ``convert("L")`` formula)
and 4:4:4 1080p q92, without restarts, as the JAX tool's re-encodes.

The JAX tool's four reference files are looked up under ``--reference``
(default: ``reference/`` inside the repository, which does not hold them
yet); each one absent is printed as ``skipped: <path> not present``.

On the CPU (``--device cpu``) both tiers run their plain twins; K1a's twin
rounds the IDCT's operands to bf16, so the table is not zero there either.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
REFERENCE_FILES = ("working-jpegs/huff_simple0.jpg",
                   "working-jpegs/lena-bw.jpeg", "lena.jpeg",
                   "2x2-chroma.jpeg")
# (name, width, height, quality, sampling, seed, a restart a MCU row)
CASES = (
    ("synthetic 4K q70", 3840, 2160, 70, "4:2:0", 0, True),
    ("synthetic 4K q85", 3840, 2160, 85, "4:2:0", 0, True),
    ("synthetic 4K q95", 3840, 2160, 95, "4:2:0", 0, True),
    ("synthetic 1080p q85", 1920, 1080, 85, "4:2:0", 1, True),
    ("grayscale 1080p q90", 1920, 1080, 90, "gray", 1, False),
    ("4:4:4 1080p q92", 1920, 1080, 92, "4:4:4", 1, False),
)
MAX_DIFF = 2
MIN_PSNR = 50.0


def luma(img: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: ITU-R 601-2 luma in 16-bit fixed point."""
    rgb = img.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def case_stream(case) -> bytes:
    """The JPEG bytes of one entry of :data:`CASES`."""
    from jpeg_tpu_torch.io.corpus import synthetic_image
    from jpeg_tpu_torch.models.encoder import encode_rgb

    _, w, h, quality, sampling, seed, restart = case
    img = synthetic_image(w, h, seed)
    if sampling == "gray":
        return encode_rgb(luma(img), quality=quality, grayscale=True)
    sub = {"4:2:0": (2, 2), "4:4:4": (1, 1)}[sampling]
    mcu_w = 8 * sub[0]
    return encode_rgb(img, quality=quality, subsampling=sub,
                      restart_interval_mcus=-(-w // mcu_w) if restart else 0)


def one(name, data, device="cuda"):
    """Print the row of one stream; returns (max |diff| u8, PSNR dB)."""
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.models.decoder import decode_plan_fast

    plan = parse_jpeg(data)
    exact = decode_plan_fast(plan, device=device, idct_mode="exact")
    approx = decode_plan_fast(plan, device=device, idct_mode="approx")
    d = np.abs(exact.astype(np.int32) - approx.astype(np.int32))
    mse = float((d.astype(np.float64) ** 2).mean())
    psnr = 10 * np.log10(255**2 / mse) if mse > 0 else float("inf")
    print(f"| {name} | {plan.width}x{plan.height} | {int(d.max())} | "
          f"{psnr:.1f} |", flush=True)
    return int(d.max()), psnr


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jpeg_tpu_torch.tools.measure_approx_quality",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="decode device (cuda or cpu: the plain twins)")
    p.add_argument("--reference", default=os.path.join(REPO, "reference"),
                   help="directory of the JAX tool's reference files")
    args = p.parse_args(argv)
    from jpeg_tpu_torch.cli import _device

    dev = _device(args.device)  # no card is an error, not a CPU run
    cases = []
    for rel in REFERENCE_FILES:
        path = os.path.join(args.reference, rel)
        if not os.path.exists(path):
            print(f"skipped: {path} not present", flush=True)
            continue
        with open(path, "rb") as f:
            cases.append((os.path.basename(path), f.read()))
    cases += [(case[0], case_stream(case)) for case in CASES]

    print("| stream | size | max diff (u8) | PSNR vs exact (dB) |")
    print("|---|---|---|---|")
    worst_d, worst_p = 0, float("inf")
    for name, data in cases:
        d, psnr = one(name, data, dev)
        worst_d, worst_p = max(worst_d, d), min(worst_p, psnr)
    print(f"\nworst-case: max diff {worst_d}, PSNR {worst_p:.1f} dB "
          f"(gate: diff <= {MAX_DIFF}, PSNR >= {MIN_PSNR:g})", flush=True)
    if worst_d > MAX_DIFF or worst_p < MIN_PSNR:
        print("approx tier FAILS the gate", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
