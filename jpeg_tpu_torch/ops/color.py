"""Colour conversions and the narrowing to samples, on torch tensors.

Counterpart of ``jpeg_tpu/ops/color.py``: YCbCr, gray, RGB-direct and Adobe
CMYK / YCCK to RGB, u8 at 8-bit precision and u16 at 12-bit (``maxval``
4095: level shift 2048, clamp to 4095; CMYK / YCCK stay 8-bit, as in the
JAX package). The reference
derives G from the already computed R and B (``src/jpeg/decoder.rs:392-402``);
the operations run in that order, in float32, so the truncate mode matches
the reference bit for bit. K1 (``csrc/fused_plane.cu``) repeats the same
order with round-to-nearest intrinsics. :func:`ycbcr_to_rgb_matrix` is a
NumPy copy of the JAX module's [3, 3] form of the same algebra.

- ``rounding="truncate"``: clamp to [0, 255], then truncate (Rust ``as u8``).
- ``rounding="round"``: ``floor(x + 0.5)`` first (libjpeg-like).
"""

from __future__ import annotations

import numpy as np
import torch

C_RED = 0.299
C_GREEN = 0.587
C_BLUE = 0.114

# float32 constants exactly as the JAX package rounds them (np.float32 of the
# float64 expression).
K_RED = torch.tensor(2.0 - 2.0 * C_RED, dtype=torch.float32).item()
K_BLUE = torch.tensor(2.0 - 2.0 * C_BLUE, dtype=torch.float32).item()


def ycbcr_to_rgb_matrix(dtype=np.float32) -> np.ndarray:
    """[3, 3] M with rgb = M @ (y, cb, cr) for *centered* (un-level-shifted)
    planes; add 128 afterwards. Mirrors the reference's exact algebra:
    r = (2-2*cr_w)*cr + y; b = (2-2*cb_w)*cb + y; g = (y - cb_w*b - cr_w*r)/g_w.
    """
    r_cr = 2.0 - 2.0 * C_RED
    b_cb = 2.0 - 2.0 * C_BLUE
    # g = (y - C_BLUE*b - C_RED*r)/C_GREEN with r, b substituted:
    g_y = (1.0 - C_BLUE - C_RED) / C_GREEN
    g_cb = -C_BLUE * b_cb / C_GREEN
    g_cr = -C_RED * r_cr / C_GREEN
    m = np.array(
        [
            [1.0, 0.0, r_cr],
            [g_y, g_cb, g_cr],
            [1.0, b_cb, 0.0],
        ],
        dtype=np.float64,
    )
    return m.astype(dtype)


def quantize_u8(x: torch.Tensor, rounding: str = "truncate") -> torch.Tensor:
    """Clamp float samples to [0, 255] and narrow to uint8."""
    if rounding == "round":
        x = torch.floor(x + 0.5)
    elif rounding != "truncate":
        raise ValueError(f"unknown rounding {rounding!r}")
    return x.clamp(0.0, 255.0).to(torch.int32).to(torch.uint8)


def quantize_samples(x: torch.Tensor, rounding: str = "truncate",
                     maxval: int = 255) -> torch.Tensor:
    """Clamp to [0, maxval] and narrow: u8 at 8-bit precision, u16 above
    (12-bit, maxval 4095), with :func:`quantize_u8`'s rounding modes. The
    u16 result is computed in float32 and int32 and narrowed by one
    ``.to(torch.uint16)``, the only u16 operation it runs on the device."""
    if maxval <= 255:
        return quantize_u8(x, rounding)
    if rounding == "round":
        x = torch.floor(x + 0.5)
    elif rounding != "truncate":
        raise ValueError(f"unknown rounding {rounding!r}")
    return x.clamp(0.0, float(maxval)).to(torch.int32).to(torch.uint16)


def level_shift(maxval: int) -> float:
    """The level shift of ``maxval``'s precision: 128 at 8 bits, 2048 at 12."""
    return float((maxval + 1) // 2)


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                 rounding: str = "truncate", maxval: int = 255) -> torch.Tensor:
    """Centered float32 planes [..., H, W] -> RGB [..., 3, H, W] (planar,
    the layout K1 writes), u8 or, above ``maxval`` 255, u16."""
    c_blue = torch.tensor(C_BLUE, dtype=torch.float32, device=y.device)
    c_red = torch.tensor(C_RED, dtype=torch.float32, device=y.device)
    c_green = torch.tensor(C_GREEN, dtype=torch.float32, device=y.device)
    r = cr * K_RED + y
    b = cb * K_BLUE + y
    g = (y - c_blue * b - c_red * r) / c_green
    shift = level_shift(maxval)
    rgb = torch.stack([r + shift, g + shift, b + shift], dim=-3)
    return quantize_samples(rgb, rounding, maxval)


def grayscale_to_rgb(y: torch.Tensor, rounding: str = "truncate",
                     maxval: int = 255) -> torch.Tensor:
    """Centered gray plane [..., H, W] -> replicated RGB [..., 3, H, W]
    (stacked before the narrowing: the same samples, and no u16 copy)."""
    u = y + level_shift(maxval)
    return quantize_samples(torch.stack([u, u, u], dim=-3), rounding, maxval)


def cmyk_to_rgb(c: torch.Tensor, m: torch.Tensor, y: torch.Tensor,
                k: torch.Tensor, rounding: str = "truncate",
                ycck: bool = False) -> torch.Tensor:
    """Adobe 4-component (CMYK / YCCK) centered planes [..., H, W] -> RGB
    u8 [..., 3, H, W].

    Adobe CMYK JPEGs store inverted ink (s = 255 - ink), so ``R = s_C *
    s_K / 255`` on the stored samples (libjpeg's output read as Pillow's
    ``CMYK;I``). For YCCK (APP14 transform 2) the first three planes are
    YCbCr of the non-inverted CMY: convert, un-invert, then apply K. The
    YCbCr products run in the JAX package's order."""
    s_k = (k + 128.0).clamp(0.0, 255.0)
    if ycck:
        c_blue = torch.tensor(C_BLUE, dtype=torch.float32, device=c.device)
        c_red = torch.tensor(C_RED, dtype=torch.float32, device=c.device)
        c_green = torch.tensor(C_GREEN, dtype=torch.float32, device=c.device)
        r = c + K_RED * y  # here (c, m, y) = (Y, Cb, Cr)
        b = c + K_BLUE * m
        g = (c - c_blue * b - c_red * r) / c_green
        stored = [255.0 - (p + 128.0).clamp(0.0, 255.0) for p in (r, g, b)]
    else:
        stored = [(p + 128.0).clamp(0.0, 255.0) for p in (c, m, y)]
    scale = s_k * torch.tensor(1.0 / 255.0, dtype=torch.float32).item()
    rgb = torch.stack(stored, dim=-3) * scale.unsqueeze(-3)
    return quantize_u8(rgb, rounding)


def rgb_direct(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               rounding: str = "truncate", maxval: int = 255) -> torch.Tensor:
    """3-component stream already in RGB (Adobe transform 0, or component
    ids R, G, B): level shift only -> RGB [..., 3, H, W]."""
    shift = level_shift(maxval)
    return quantize_samples(
        torch.stack([r + shift, g + shift, b + shift], dim=-3), rounding,
        maxval)
