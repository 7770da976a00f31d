"""YCbCr->RGB and the u8 narrowing, on torch tensors.

Counterpart of ``jpeg_tpu/ops/color.py`` for 8-bit samples. The reference
derives G from the already computed R and B (``src/jpeg/decoder.rs:392-402``);
the operations run in that order, in float32, so the truncate mode matches
the reference bit for bit. K1 (``csrc/fused_plane.cu``) repeats the same
order with round-to-nearest intrinsics.

- ``rounding="truncate"``: clamp to [0, 255], then truncate (Rust ``as u8``).
- ``rounding="round"``: ``floor(x + 0.5)`` first (libjpeg-like).
"""

from __future__ import annotations

import torch

C_RED = 0.299
C_GREEN = 0.587
C_BLUE = 0.114

# float32 constants exactly as the JAX package rounds them (np.float32 of the
# float64 expression).
K_RED = torch.tensor(2.0 - 2.0 * C_RED, dtype=torch.float32).item()
K_BLUE = torch.tensor(2.0 - 2.0 * C_BLUE, dtype=torch.float32).item()


def quantize_u8(x: torch.Tensor, rounding: str = "truncate") -> torch.Tensor:
    """Clamp float samples to [0, 255] and narrow to uint8."""
    if rounding == "round":
        x = torch.floor(x + 0.5)
    elif rounding != "truncate":
        raise ValueError(f"unknown rounding {rounding!r}")
    return x.clamp(0.0, 255.0).to(torch.int32).to(torch.uint8)


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                 rounding: str = "truncate") -> torch.Tensor:
    """Centered float32 planes [..., H, W] -> RGB u8 [..., 3, H, W] (planar,
    the layout K1 writes)."""
    c_blue = torch.tensor(C_BLUE, dtype=torch.float32, device=y.device)
    c_red = torch.tensor(C_RED, dtype=torch.float32, device=y.device)
    c_green = torch.tensor(C_GREEN, dtype=torch.float32, device=y.device)
    r = cr * K_RED + y
    b = cb * K_BLUE + y
    g = (y - c_blue * b - c_red * r) / c_green
    rgb = torch.stack([r + 128.0, g + 128.0, b + 128.0], dim=-3)
    return quantize_u8(rgb, rounding)


def grayscale_to_rgb(y: torch.Tensor, rounding: str = "truncate") -> torch.Tensor:
    """Centered gray plane [..., H, W] -> replicated RGB u8 [..., 3, H, W]."""
    u = quantize_u8(y + 128.0, rounding)
    return torch.stack([u, u, u], dim=-3)
