"""The decode model: JPEG bytes -> RGB u8, through the fast path.

Counterpart of ``jpeg_tpu/models/decoder.py`` for 8-bit baseline Huffman
streams (YCbCr or gray): entropy decode into int16 coefficient planes on the
host (C++ runtime) or on the device (K3 + :func:`coefficient_planes_from_blocks`),
then K1 (``ops/fused_plane.py``) for dequant, IDCT, upsample and colour.

Routes of the JAX package that lead off this slice raise
``NotImplementedError`` naming their ``ROADMAP.md`` item; nothing falls back
silently.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jpeg_tpu_torch.io.container import DecodePlan, parse_jpeg
from jpeg_tpu_torch.ops.zigzag import NATURAL_TO_ZIGZAG
from jpeg_tpu_torch.runtime import native_decode_planes


@dataclasses.dataclass(frozen=True)
class PipelineGeometry:
    """Static shape info for one image class: the batch bucket key."""

    width: int
    height: int
    mcus_x: int
    mcus_y: int
    h_max: int
    v_max: int
    sampling: tuple[tuple[int, int], ...]  # (h, v) per component, scan order
    color_model: str = "ycbcr"  # gray | ycbcr | rgb | cmyk | ycck
    precision: int = 8

    @staticmethod
    def of(plan: DecodePlan) -> "PipelineGeometry":
        return PipelineGeometry(
            width=plan.width, height=plan.height,
            mcus_x=plan.mcus_x, mcus_y=plan.mcus_y,
            h_max=plan.h_max, v_max=plan.v_max,
            sampling=tuple((c.h, c.v) for c in plan.components),
            color_model=plan.color_model, precision=plan.precision)

    @property
    def blocks_per_mcu(self) -> int:
        return sum(h * v for h, v in self.sampling)

    @property
    def n_mcus(self) -> int:
        return self.mcus_x * self.mcus_y

    @property
    def total_blocks(self) -> int:
        return self.n_mcus * self.blocks_per_mcu

    def component_slot_ranges(self) -> list[tuple[int, int]]:
        """Per component: (offset, count) of its block slots within one MCU
        (each component's v*h blocks are contiguous, JPEG A.2.3)."""
        out, offset = [], 0
        for h, v in self.sampling:
            out.append((offset, h * v))
            offset += h * v
        return out


def not_ported(what: str, item: int):
    """The error for a route this package does not run yet."""
    return NotImplementedError(
        f"{what} is not ported to jpeg_tpu_torch yet "
        f"(ROADMAP.md, 'Still to port' item {item})")


def check_fast_path(plan: DecodePlan) -> None:
    """Raise ``NotImplementedError`` for streams off the ported slice (8-bit
    baseline Huffman, YCbCr or gray)."""
    if plan.lossless:
        raise not_ported("lossless (SOF3) decode", 7)
    if plan.progressive:
        raise not_ported("progressive decode", 3)
    if plan.arith_code:
        raise not_ported("arithmetic-coded decode", 3)
    if plan.precision != 8:
        raise not_ported(f"{plan.precision}-bit decode", 3)
    if plan.color_model not in ("ycbcr", "gray"):
        raise not_ported(f"{plan.color_model} colour (compat pipeline)", 1)


def coefficient_planes_from_blocks(coeffs: torch.Tensor,
                                   geom: PipelineGeometry) -> list[torch.Tensor]:
    """Stream-ordered zigzag blocks [total_blocks, 64] -> per-component
    natural-order int16 planes in the padded layout the C++ runtime writes
    (pad regions zero), on ``coeffs.device``. Values outside int16 wrap, as
    the runtime's int16 stores do. This is how device-decoded entropy joins
    the same K1 route as host-decoded images."""
    from jpeg_tpu_torch.ops.fused_plane import padded_plane_shapes

    nat = torch.as_tensor(NATURAL_TO_ZIGZAG, dtype=torch.int64,
                          device=coeffs.device)
    mcu_view = coeffs.reshape(geom.n_mcus, geom.blocks_per_mcu, 64)
    my, mx = geom.mcus_y, geom.mcus_x
    planes = []
    for (h, v), (off, k), (rows, cols) in zip(
            geom.sampling, geom.component_slot_ranges(),
            padded_plane_shapes(geom)):
        c = mcu_view[:, off : off + k].index_select(-1, nat)
        c = (c.reshape(my, mx, v, h, 8, 8).permute(0, 2, 4, 1, 3, 5)
             .reshape(my * v * 8, mx * h * 8))
        plane = torch.zeros((rows, cols), dtype=torch.int16, device=coeffs.device)
        plane[: my * v * 8, : mx * h * 8] = c.to(torch.int16)
        planes.append(plane)
    return planes


def decode_plan_fast(plan: DecodePlan, rounding: str = "truncate",
                     device="cuda", idct_mode: str = "exact") -> np.ndarray:
    """C++ plane-layout entropy + K1 on ``device`` -> RGB [H, W, 3] u8."""
    from jpeg_tpu_torch.ops.fused_plane import decode_planes_fused

    if idct_mode != "exact":
        raise not_ported(f"idct_mode={idct_mode!r}", 1)
    check_fast_path(plan)
    return decode_planes_fused(native_decode_planes(plan), plan, rounding,
                               device)


def decode_bytes(data: bytes, rounding: str = "truncate",
                 path: str = "fast", device="cuda",
                 upsample: str = "replicate", color_space: str = "rgb",
                 idct_mode: str = "exact") -> np.ndarray:
    """JPEG bytes -> RGB [H, W, 3] u8 numpy array, decoded on ``device``.

    Only ``path="fast"`` (the JAX package's default is its compat pipeline,
    not ported yet) with replicate upsampling and RGB output."""
    if path != "fast":
        raise not_ported(f"path={path!r}", 1)
    if upsample != "replicate":
        raise not_ported(f"upsample={upsample!r}", 1)
    if color_space != "rgb":
        raise not_ported(f"color_space={color_space!r}", 1)
    return decode_plan_fast(parse_jpeg(data), rounding, device, idct_mode)


def apply_exif_orientation(rgb: np.ndarray, orientation: int | None) -> np.ndarray:
    """Apply an EXIF orientation tag (1-8) to a decoded [H, W, 3] image."""
    if not orientation or orientation == 1:
        return rgb
    ops = {
        2: lambda x: x[:, ::-1],
        3: lambda x: x[::-1, ::-1],
        4: lambda x: x[::-1],
        5: lambda x: x.transpose(1, 0, 2),
        6: lambda x: x.transpose(1, 0, 2)[:, ::-1],
        7: lambda x: x.transpose(1, 0, 2)[::-1, ::-1],
        8: lambda x: x.transpose(1, 0, 2)[::-1],
    }
    fn = ops.get(orientation)
    return np.ascontiguousarray(fn(rgb)) if fn else rgb


def decode_file(path, rounding: str = "truncate", device="cuda",
                exif_orientation: bool = False) -> np.ndarray:
    """Decode a JPEG file on ``device``; ``exif_orientation=True`` applies
    the EXIF orientation tag."""
    with open(path, "rb") as f:
        plan = parse_jpeg(f.read())
    rgb = decode_plan_fast(plan, rounding, device)
    if exif_orientation:
        rgb = apply_exif_orientation(rgb, (plan.exif or {}).get("orientation"))
    return rgb
