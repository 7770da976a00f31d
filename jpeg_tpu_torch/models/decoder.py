"""The decode model: JPEG bytes -> RGB u8, through the compat or the fast path.

Counterpart of ``jpeg_tpu/models/decoder.py`` for every stream it
decodes: baseline, extended and progressive DCT at 8 and 12 bits, Huffman or
arithmetic coded, in gray, YCbCr, RGB-direct, CMYK or YCCK, and lossless
(SOF3), with its defaults:

- the compat path (``path="compat"``, the default of :func:`decode_bytes`
  and the route of :func:`decode_file`): C++ entropy decode into
  ``[total_blocks, 64]`` int32 blocks (:func:`decode_coefficients_host`),
  then per component one ``[n, 64] @ [64, 64]`` fp32 product with the fused
  dequant + unzigzag + IDCT matrix (``torch.matmul``, TF32 refused),
  assembly, replicate or fancy upsample and colour, or the level-shifted
  planes themselves (``color_space="ycbcr"``) (:func:`decode_plan`);
  12-bit frames come out as ``uint16`` (level shift 2048, clamp 4095);
  lossless frames are their samples (``entropy/lossless.py``), ``uint8`` up
  to 8 bits and ``uint16`` above, gray replicated to three channels;
- the fast path (``path="fast"``, and the corpus decoder's route) for gray
  and YCbCr streams: entropy decode into int16 coefficient planes on the
  host (C++ runtime, every entropy coding) or on the device (K3 +
  :func:`coefficient_planes_from_blocks`), then K1 (``ops/fused_plane.py``)
  for dequant, IDCT, upsample and colour. It is within +-1 u8 of the compat
  path. ``idct_mode="approx"`` runs K1a instead, K1 with the IDCT's operands
  rounded to bf16 as the TPU's DEFAULT precision rounds them (within 2 u8
  and 50 dB of exact, ``docs/APPROX_QUALITY.md``). Other colour models,
  12-bit and lossless frames take the compat path, as in the JAX package.

The host entropy stage runs the C++ runtime (``engine="auto"`` or
``"native"``) or the NumPy reference decoders (``engine="oracle"``,
``entropy/oracle.py``, ``progressive.py``, ``arith.py``). ``"auto"`` does not
fall back to the oracle when the runtime fails to build, as the JAX package
does: the build error raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jpeg_tpu_torch.entropy import arith, oracle, progressive
from jpeg_tpu_torch.io.container import DecodePlan, parse_jpeg
from jpeg_tpu_torch.ops.color import (
    cmyk_to_rgb,
    grayscale_to_rgb,
    level_shift,
    quantize_samples,
    rgb_direct,
    ycbcr_to_rgb,
)
from jpeg_tpu_torch.ops.idct import fused_idct_matrix
from jpeg_tpu_torch.ops.upsample import component_plane
from jpeg_tpu_torch.ops.zigzag import NATURAL_TO_ZIGZAG
from jpeg_tpu_torch.runtime import (
    native_decode_arith_coefficients,
    native_decode_arith_planes,
    native_decode_coefficients,
    native_decode_planes,
    native_decode_progressive,
    native_decode_progressive_planes,
)


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

    def component_gather_indices(self) -> list[np.ndarray]:
        """Flat stream-row indices per component (used by host-side code and
        tests; the pipeline uses :meth:`component_slot_ranges`)."""
        bpm = self.blocks_per_mcu
        base = np.arange(self.n_mcus, dtype=np.int32)[:, None] * bpm
        return [
            (base + np.arange(off, off + k, dtype=np.int32)[None, :]).reshape(-1)
            for off, k in self.component_slot_ranges()
        ]


def fast_path_takes(plan: DecodePlan) -> bool:
    """Whether K1 decodes the plan: 8-bit DCT samples in gray or YCbCr. K1
    bakes in the YCbCr matrix and writes three u8 channels from int16
    planes, so RGB-direct, CMYK, YCCK, 12-bit and lossless streams take the
    compat path, as in the JAX package (``decode_plan_fast``)."""
    return (plan.color_model in ("ycbcr", "gray") and not plan.lossless
            and plan.precision == 8)


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


def plan_matrices(plan: DecodePlan) -> np.ndarray:
    """[n_comp, 64, 64] f32 fused dequant + unzigzag + IDCT matrices."""
    return np.stack([fused_idct_matrix(plan.quant_tables[c.quant_id])
                     for c in plan.components])


def decode_coefficients_host(plan: DecodePlan, engine: str = "auto") -> np.ndarray:
    """Entropy-decode on the host -> ``[total_blocks, 64]`` int32 zigzag
    blocks, DC prediction applied, MCU stream order.

    ``engine``: ``"auto"`` and ``"native"`` run the C++ runtime (a failed
    build raises: ``"auto"`` does not fall back to the oracle as in the JAX
    package): progressive plans (SOF2, SOF10) through
    ``native_decode_progressive``, sequential arithmetic (SOF9) through
    ``native_decode_arith_coefficients``, baseline Huffman through
    ``native_decode_coefficients``. ``"oracle"`` runs the NumPy reference
    decoders, routed as in the JAX package: baseline to
    ``decode_coefficients``, progressive to
    ``decode_progressive_coefficients``, SOF9 to
    ``decode_coefficients_arith``, SOF10 to
    ``decode_progressive_coefficients_arith``. A baseline Huffman plan's
    array from the runtime is its per-thread scratch buffer: consume or copy
    it before this thread decodes another image of the same block count."""
    if engine not in ("auto", "native", "oracle"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "oracle":
        return decode_coefficients_oracle(plan)
    if plan.progressive:
        return native_decode_progressive(plan)
    if plan.arith_code:
        return native_decode_arith_coefficients(plan)
    return native_decode_coefficients(plan)


def decode_coefficients_oracle(plan: DecodePlan) -> np.ndarray:
    """The NumPy reference decoders -> ``[total_blocks, 64]`` int32 zigzag
    blocks, as :func:`decode_coefficients_host` returns them."""
    if plan.arith_code:
        if plan.progressive:
            return arith.decode_progressive_coefficients_arith(plan)
        return arith.decode_coefficients_arith(plan)
    if plan.progressive:
        return progressive.decode_progressive_coefficients(plan)
    return oracle.decode_coefficients(plan)


def progressive_planes(plan: DecodePlan) -> list[np.ndarray]:
    """Progressive (SOF2 or SOF10) entropy decode -> int16 coefficient planes
    in K1's layout, all in C++. The planes are the runtime's per-thread
    scratch buffers (``native_decode_progressive_planes``): consume or copy
    them before this thread decodes another image of the same geometry."""
    return native_decode_progressive_planes(plan)


def host_planes(plan: DecodePlan, n_threads: int | None = None
                ) -> list[np.ndarray]:
    """The fast path's host entropy stage for any 8-bit DCT plan -> int16
    planes in K1's layout, this thread's scratch buffers: progressive plans
    through :func:`progressive_planes`, SOF9 plans through
    ``native_decode_arith_planes``, baseline Huffman through
    ``native_decode_planes`` with ``n_threads``. The first two take the cpu
    count's threads, as in the JAX package."""
    if plan.progressive:
        return progressive_planes(plan)
    if plan.arith_code:
        return native_decode_arith_planes(plan)
    return native_decode_planes(plan, n_threads)


def _pipeline(coeffs: torch.Tensor, matrices: torch.Tensor,
              geom: PipelineGeometry, rounding: str,
              upsample: str = "replicate",
              color_space: str = "rgb") -> torch.Tensor:
    """coeffs [..., total_blocks, 64] int32 (zigzag), matrices [...,
    n_comp, 64, 64] f32, on one device -> RGB [..., H, W, 3] there, u8 at
    8-bit precision and u16 at 12-bit (``geom.precision``). Per component
    one product at full fp32 (one for the whole batch), then assembly,
    upsample, crop and colour. ``color_space="ycbcr"`` returns the
    level-shifted full-resolution planes instead: 3 channels for gray (the
    missing two at the level shift) and YCbCr streams, 4 for CMYK and
    YCCK."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise ValueError(
            "the compat decode needs full fp32 products: turn off "
            "torch.backends.cuda.matmul.allow_tf32 (or "
            "torch.set_float32_matmul_precision('highest'))")
    if color_space not in ("rgb", "ycbcr"):
        raise ValueError(f"unknown color_space {color_space!r}")
    batch = coeffs.shape[:-2]
    mcu_view = coeffs.to(torch.float32).reshape(
        *batch, geom.n_mcus, geom.blocks_per_mcu, 64)
    planes = []
    for ci, ((h, v), (off, k)) in enumerate(
            zip(geom.sampling, geom.component_slot_ranges())):
        pixels = torch.matmul(
            mcu_view[..., off : off + k, :].reshape(*batch, -1, 64),
            matrices[..., ci, :, :])
        planes.append(component_plane(
            pixels.reshape(*batch, -1, 8, 8), geom.mcus_y, geom.mcus_x, v, h,
            geom.v_max, geom.h_max, geom.height, geom.width, upsample))
    maxval = (1 << geom.precision) - 1
    shift = level_shift(maxval)
    if color_space == "ycbcr":
        # Stacked in float32 before the narrowing (the missing channels at
        # the shift narrow to it), so no u16 tensor is stacked.
        chans = [p + shift for p in planes]
        while len(chans) < 3:
            chans.append(torch.full_like(chans[0], shift))
        return quantize_samples(torch.stack(chans, dim=-1), rounding, maxval)
    if len(planes) == 1:
        rgb = grayscale_to_rgb(planes[0], rounding, maxval)
    elif len(planes) == 3 and geom.color_model == "rgb":
        rgb = rgb_direct(*planes, rounding=rounding, maxval=maxval)
    elif len(planes) == 3:
        rgb = ycbcr_to_rgb(*planes, rounding=rounding, maxval=maxval)
    elif len(planes) == 4:
        rgb = cmyk_to_rgb(*planes, rounding=rounding,
                          ycck=geom.color_model == "ycck")
    else:
        raise ValueError(f"unsupported component count {len(planes)}")
    return rgb.movedim(-3, -1)


def decode_plan(plan: DecodePlan, rounding: str = "truncate",
                engine: str = "auto", coefficients: np.ndarray | None = None,
                upsample: str = "replicate", color_space: str = "rgb",
                device="cuda") -> np.ndarray:
    """The compat decode: DecodePlan -> RGB [H, W, 3] numpy array (u8, or
    u16 at 12-bit precision; the level-shifted planes with
    ``color_space="ycbcr"``), the dense stage on ``device``.
    ``coefficients`` (``[total_blocks, 64]`` int32 zigzag) skips the entropy
    decode. ``upsample``: ``"replicate"`` (the reference's) or ``"fancy"``
    (libjpeg's triangular filter).

    A lossless (SOF3) plan returns its samples as the JAX package does
    (colour options do not apply): :func:`~jpeg_tpu_torch.entropy.lossless.
    decode_lossless` with the cumsum reconstruction on ``device`` where it
    applies and ``engine`` elsewhere; gray replicated to three channels,
    ``uint8`` up to 8 bits."""
    if plan.lossless:
        from jpeg_tpu_torch.entropy.lossless import decode_lossless

        samples = decode_lossless(plan, device=device, engine=engine)
        if samples.shape[2] == 1:
            samples = np.repeat(samples, 3, axis=2)
        if plan.precision <= 8:
            samples = samples.astype(np.uint8)
        return samples
    if coefficients is None:
        coefficients = decode_coefficients_host(plan, engine)
    coeffs = torch.as_tensor(np.asarray(coefficients, np.int32), device=device)
    matrices = torch.as_tensor(plan_matrices(plan), device=device)
    return _pipeline(coeffs, matrices, PipelineGeometry.of(plan), rounding,
                     upsample, color_space).cpu().numpy()


def decode_plan_fast(plan: DecodePlan, rounding: str = "truncate",
                     device="cuda", idct_mode: str = "exact") -> np.ndarray:
    """C++ plane-layout entropy (baseline, progressive or SOF9) + K1 on
    ``device`` -> RGB [H, W, 3] u8; K1a with ``idct_mode="approx"``. Plans
    K1 does not take (:func:`fast_path_takes`: other colour models, 12-bit,
    lossless) go to :func:`decode_plan` on ``device``, exact whatever
    ``idct_mode``, as in the JAX package."""
    from jpeg_tpu_torch.ops.fused_plane import check_idct_mode, decode_planes_fused

    check_idct_mode(idct_mode)
    if not fast_path_takes(plan):
        return decode_plan(plan, rounding, device=device)
    return decode_planes_fused(host_planes(plan), plan, rounding, device,
                               idct_mode)


def decode_bytes(data: bytes, rounding: str = "truncate",
                 engine: str = "auto", path: str = "compat",
                 upsample: str = "replicate", color_space: str = "rgb",
                 idct_mode: str = "exact", device="cuda") -> np.ndarray:
    """JPEG bytes -> RGB [H, W, 3] numpy array, decoded on ``device``: u8,
    or u16 for 12-bit frames and lossless frames above 8 bits.

    ``path="compat"`` (default, as in the JAX package) runs
    :func:`decode_plan` with ``engine``, ``upsample`` and ``color_space``;
    ``path="fast"`` with RGB output runs K1 (:func:`decode_plan_fast`,
    which alone reads ``idct_mode``: K1a for ``"approx"``) for gray and
    YCbCr streams, within +-1 u8 of compat, and ignores ``upsample`` and
    ``engine`` there as the JAX package does. Every other stream (other
    colour models, 12-bit, lossless) or colour space takes the compat
    path."""
    if path not in ("compat", "fast"):
        raise ValueError(f"unknown path {path!r}")
    plan = parse_jpeg(data)
    if path == "fast" and color_space == "rgb" and fast_path_takes(plan):
        return decode_plan_fast(plan, rounding, device, idct_mode)
    return decode_plan(plan, rounding, engine, upsample=upsample,
                       color_space=color_space, device=device)


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


def decode_file(path, rounding: str = "truncate", engine: str = "auto",
                exif_orientation: bool = False, device="cuda") -> np.ndarray:
    """Decode a JPEG file through the compat path on ``device``;
    ``exif_orientation=True`` applies the EXIF orientation tag."""
    with open(path, "rb") as f:
        plan = parse_jpeg(f.read())
    rgb = decode_plan(plan, rounding, engine, device=device)
    if exif_orientation:
        rgb = apply_exif_orientation(rgb, (plan.exif or {}).get("orientation"))
    return rgb
