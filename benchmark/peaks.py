"""Peaks of the card and the work a kernel's inputs need, from shapes.

The peaks are NVIDIA's data sheet for the H100 SXM (dense rates, no
sparsity), at its 700 W limit. The operation counts are those of the
program's kernel bounds (K1, K2: two 1-D passes of 8 products and 7 sums
per output and block, K1 forming the mirrored products once; one
(de)quantise product per coefficient; the colour operations per pixel).
Bytes count each input read once and each output written once, at the
frame's own size: the coefficients of its MCUs as int16, its pixels as u8.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12  # dense bf16 tensor cores (K1a's IDCT)

OPS_PER_BLOCK = 2 * 64 * 15 + 64             # K2's forward DCT + quantise
K1_OPS_PER_BLOCK = 2 * (32 * 8 + 64 * 7) + 64  # K1's IDCT + dequantise
K1_COLOUR_OPS_PER_PIXEL = 12
K2_COLOUR_OPS_PER_PIXEL = 15


def bound_s(n_bytes: float, n_ops: float = 0.0) -> float:
    """The least seconds for ``n_bytes`` moved and ``n_ops`` fp32
    operations, each at its peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def geometry(cfg: dict) -> dict:
    """Blocks and pixels of one frame of a configuration: ``sampling`` is
    the luma's (h, v); chroma is 1x1."""
    h, v = cfg["sampling"]
    mcus = -(-cfg["width"] // (8 * h)) * -(-cfg["height"] // (8 * v))
    return {"blocks": mcus * (h * v + 2), "pixels": cfg["width"] * cfg["height"],
            "components": 3}


def k1_bound_s(cfg: dict, frames: int) -> float:
    """K1 on ``frames`` frames: coefficients and tables read, RGB written."""
    g = geometry(cfg)
    n_bytes = frames * (g["blocks"] * 128 + g["components"] * 256
                        + 3 * g["pixels"])
    ops = frames * (g["blocks"] * K1_OPS_PER_BLOCK
                    + K1_COLOUR_OPS_PER_PIXEL * g["pixels"])
    return bound_s(n_bytes, ops)


def k2_bound_s(cfg: dict, frames: int) -> float:
    """K2 on ``frames`` frames: RGB and reciprocal tables read,
    coefficients written."""
    g = geometry(cfg)
    n_bytes = frames * (3 * g["pixels"] + g["components"] * 256
                        + g["blocks"] * 128)
    ops = frames * (g["blocks"] * OPS_PER_BLOCK
                    + K2_COLOUR_OPS_PER_PIXEL * g["pixels"])
    return bound_s(n_bytes, ops)


def k3_bound_s(cfg: dict, frames: int, scan_bytes: int) -> float:
    """K3 on ``frames`` frames holding ``scan_bytes`` of entropy-coded data:
    the data read, the coefficients written; its lookups are table reads
    counted with neither."""
    return bound_s(scan_bytes + frames * geometry(cfg)["blocks"] * 128)
