"""K1, the fused pixel stage: int16 coefficient planes -> planar RGB u8,
and K1a, its approx tier.

Counterpart of the fast path in ``jpeg_tpu/ops/pallas_kernels.py``
(``fused_plane_decoder`` / ``_plane_kernel``, ``padded_plane_shapes``,
``plan_quant_patterns``, ``decode_planes_fused``). The CUDA kernel is
``csrc/fused_plane.cu``; :func:`fused_plane_decode_plain` is its plain
PyTorch twin, computing the same fp32 operations in the same order.

``idct_mode="approx"`` (K1a) is the JAX kernel's DEFAULT-precision tier:
the IDCT's operands rounded to bf16, its sums in fp32
(:func:`~jpeg_tpu_torch.ops.idct.idct_blocks_plain` with ``bf16=True``),
the same kernel instantiated with a flag, whose IDCT runs on the tensor
cores (bf16 ``mma.sync``, fp32 sums). The tensor core sums the exact bf16
products in its own order, so K1a equals its twin to a tolerance (a pixel
rarely 1 u8 apart), where K1 equals its twin bit for bit. Its launches
count in :data:`LAUNCHES_APPROX`, exact K1's in :data:`LAUNCHES`.

:func:`fused_plane_decode` takes the plain version only for tensors on the
CPU. For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from jpeg_tpu_torch.ops.color import grayscale_to_rgb, ycbcr_to_rgb
from jpeg_tpu_torch.ops.idct import (
    dct_basis_1d,
    dct_basis_1d_bf16,
    idct_blocks_plain,
)
from jpeg_tpu_torch.ops.zigzag import unzigzag
from jpeg_tpu_torch.utils.build import LaunchCounter, load_cuda_kernel

# Plane layout constants, shared with the C++ runtime that writes the planes:
# Y strides are padded to whole TILE_W column tiles, rows to whole BAND_ROWS
# bands (pad regions zero, decoded to mid-gray and cropped off).
TILE_W = 256
BAND_ROWS = 128

# K1's cell (csrc/fused_plane.cu: kTileW, kThreads): Y-resolution columns
# and threads per thread block. The shipping build is CELL; a variant build
# (tools/sweep_tiles.py) takes a tile from CELL_TILES, which divide TILE_W,
# and a thread count from CELL_THREADS.
CELL = (256, 128)
CELL_TILES = (64, 128, 256)
CELL_THREADS = (64, 128, 256)

LAUNCHES = LaunchCounter()         # K1
LAUNCHES_APPROX = LaunchCounter()  # K1a
IDCT_MODES = ("exact", "approx")


def band_mcus(geom) -> int:
    """MCU rows per band (BAND_ROWS of Y resolution)."""
    return BAND_ROWS // (8 * geom.v_max)


def n_bands(geom) -> int:
    return -(-geom.mcus_y // band_mcus(geom))


def padded_size(geom) -> tuple[int, int]:
    """(H_pad, W_pad) of the planar output: whole bands by whole tiles."""
    return (n_bands(geom) * BAND_ROWS,
            -(-geom.mcus_x * geom.h_max * 8 // TILE_W) * TILE_W)


def padded_plane_shapes(geom) -> list[tuple[int, int]]:
    """[rows, stride] per component of the padded plane layout: the Y stride
    is a multiple of TILE_W and each component's stride maps one Y tile to
    whole chroma tiles; rows cover whole BAND_ROWS bands."""
    h_pad, w_pad = padded_size(geom)
    return [(h_pad * v // geom.v_max, w_pad * h // geom.h_max)
            for (h, v) in geom.sampling]


def plan_quant_patterns(plan, geom) -> np.ndarray:
    """[n_comp, 64] f32 natural-order dequant table per component. (The TPU
    kernel tiles each table over its block; K1 indexes the 8x8 table.)"""
    return np.stack([
        unzigzag(plan.quant_tables[c.quant_id].astype(np.float32))
        for c in plan.components])


def check_idct_mode(idct_mode: str) -> None:
    if idct_mode not in IDCT_MODES:
        raise ValueError(f"unknown idct_mode {idct_mode!r}")


def _basis_np(idct_mode: str) -> np.ndarray:
    """The float32 basis of ``idct_mode``: K1's, or K1a's bf16-rounded one."""
    check_idct_mode(idct_mode)
    a = dct_basis_1d_bf16() if idct_mode == "approx" else dct_basis_1d()
    return np.ascontiguousarray(a, np.float32)


def _check_inputs(planes, qtabs, geom) -> int:
    n_comp = len(geom.sampling)
    if n_comp not in (1, 3):
        raise ValueError(f"K1 takes 1 or 3 components, got {n_comp}")
    for h, v in geom.sampling:
        # Whole upsampling factors of 1, 2 or 4 on both axes, as the kernel's
        # launcher (and K2's) takes them.
        if (h < 1 or v < 1 or geom.h_max % h or geom.v_max % v
                or geom.h_max // h not in (1, 2, 4)
                or geom.v_max // v not in (1, 2, 4)):
            raise ValueError(
                f"K1 takes upsampling factors of 1, 2 or 4: sampling {h}x{v} "
                f"against {geom.h_max}x{geom.v_max}")
    if len(planes) != n_comp:
        raise ValueError(f"expected {n_comp} planes, got {len(planes)}")
    batch = planes[0].shape[0]
    for p, shape in zip(planes, padded_plane_shapes(geom)):
        if p.dtype != torch.int16 or tuple(p.shape) != (batch, *shape):
            raise ValueError(
                f"plane must be int16 [{batch}, {shape[0]}, {shape[1]}], got "
                f"{p.dtype} {tuple(p.shape)}")
    if qtabs.dtype != torch.float32 or tuple(qtabs.shape) != (batch, n_comp, 64):
        raise ValueError(f"qtabs must be float32 [{batch}, {n_comp}, 64], got "
                         f"{qtabs.dtype} {tuple(qtabs.shape)}")
    return batch


def _rounding_mode(rounding: str) -> int:
    if rounding not in ("truncate", "round"):
        raise ValueError(f"unknown rounding {rounding!r}")
    return int(rounding == "round")


def fused_plane_decode_plain(planes, qtabs, geom, rounding: str = "truncate",
                             idct_mode: str = "exact") -> torch.Tensor:
    """Plain PyTorch K1 (``idct_mode="exact"``) or K1a (``"approx"``).
    ``planes``: per component int16 [B, rows_c, stride_c]
    (:func:`padded_plane_shapes`); ``qtabs``: f32 [B, n_comp, 64] natural
    order. Returns planar u8 [B, 3, H_pad, W_pad].

    The separable IDCT is :func:`~jpeg_tpu_torch.ops.idct.idct_blocks_plain`,
    the kernel's order of operations."""
    _check_inputs(planes, qtabs, geom)
    _rounding_mode(rounding)
    a = torch.from_numpy(_basis_np(idct_mode)).to(planes[0].device)
    spatial = []
    for ci, (h, v) in enumerate(geom.sampling):
        p = planes[ci]
        batch, rows, cols = p.shape
        f = p.to(torch.float32).view(batch, rows // 8, 8, cols // 8, 8)
        f = f * qtabs[:, ci].view(batch, 1, 8, 1, 8)
        s = idct_blocks_plain(f, a, bf16=idct_mode == "approx").reshape(
            batch, rows, cols)
        fy, fx = geom.v_max // v, geom.h_max // h
        spatial.append(s.repeat_interleave(fy, dim=1).repeat_interleave(fx, dim=2))
    if len(spatial) == 1:
        return grayscale_to_rgb(spatial[0], rounding)
    return ycbcr_to_rgb(*spatial, rounding=rounding)


def _configure(lib) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.jt_fused_plane_decode.restype = ctypes.c_int
    lib.jt_fused_plane_decode.argtypes = [
        ctypes.POINTER(vp), ctypes.POINTER(i64), ctypes.POINTER(i64),
        ctypes.POINTER(i32), ctypes.POINTER(i32),  # planes, rows, strides, h, v
        i32, i32, i32, i32,  # n_comp, h_max, v_max, MCU rows of H_pad
        vp, ctypes.POINTER(ctypes.c_float), vp,  # qtab, basis (host), out
        i64, i64, i64, i32, i32, vp,  # batch, h_pad, w_pad, round_mode,
    ]                                 # approx, stream
    lib.jt_divide_green_check.restype = ctypes.c_int
    lib.jt_divide_green_check.argtypes = [ctypes.c_uint32, ctypes.c_uint32, vp, vp]
    lib.jt_fused_plane_attributes.restype = ctypes.c_int
    lib.jt_fused_plane_attributes.argtypes = [i32, ctypes.POINTER(i32)]


def check_cell(cell) -> tuple[int, int]:
    """``cell`` as (tile columns, threads), or ``ValueError`` for a shape the
    plane layout cannot take: a tile outside :data:`CELL_TILES` (the host
    pads planes to TILE_W, which those divide) or a thread count outside
    :data:`CELL_THREADS` (a power-of-two number of warps)."""
    tile_w, threads = (int(x) for x in cell)
    if tile_w not in CELL_TILES or threads not in CELL_THREADS:
        raise ValueError(
            f"K1 cell {tile_w}x{threads}: tiles of {CELL_TILES} columns and "
            f"{CELL_THREADS} threads fit the plane layout")
    return tile_w, threads


def load_kernel(cell=None):
    """Build (at first use) and load the K1 library. ``--fmad=false`` keeps
    nvcc from contracting the colour stage's multiply-adds; the IDCT comes
    from ``csrc/idct8x8.cuh``, shared with K5 and K6. ``cell`` (tile
    columns, threads) other than :data:`CELL` builds a variant library with
    that cell (:func:`check_cell`); the shipping call is unchanged."""
    if cell is None or tuple(cell) == CELL:
        return load_cuda_kernel("fused_plane", ("--fmad=false",), _configure,
                                headers=("idct8x8.cuh",))
    tile_w, threads = check_cell(cell)
    return load_cuda_kernel(
        "fused_plane", ("--fmad=false", f"-DJT_K1_TILE_W={tile_w}",
                        f"-DJT_K1_THREADS={threads}"), _configure,
        headers=("idct8x8.cuh",), variant=f"t{tile_w}_n{threads}")


def fused_plane_decode_cuda(planes, qtabs, geom, rounding: str = "truncate",
                            idct_mode: str = "exact",
                            cell=None) -> torch.Tensor:
    """Launch K1 (or K1a for ``idct_mode="approx"``) on the current stream.
    Same contract as :func:`fused_plane_decode_plain`; every tensor must be
    on one CUDA device and contiguous, and each plane 16-byte aligned (the
    kernel loads a block row, eight int16, at a time). ``cell`` selects a
    variant build of another cell shape (:func:`load_kernel`)."""
    if cell is not None:
        check_cell(cell)
    batch = _check_inputs(planes, qtabs, geom)
    mode = _rounding_mode(rounding)
    basis = _basis_np(idct_mode)
    dev = planes[0].device
    for t in (*planes, qtabs):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("K1 inputs must be contiguous and on one device")
    if any(p.data_ptr() % 16 for p in planes):
        raise ValueError("K1 planes must start on a 16-byte boundary")
    lib = load_kernel(cell)
    shapes = padded_plane_shapes(geom)
    n_comp = len(shapes)
    h_pad, w_pad = padded_size(geom)
    out = torch.empty((batch, 3, h_pad, w_pad), dtype=torch.uint8, device=dev)
    ptrs = (ctypes.c_void_p * n_comp)(*[p.data_ptr() for p in planes])
    rows = (ctypes.c_int64 * n_comp)(*[s[0] for s in shapes])
    strides = (ctypes.c_int64 * n_comp)(*[s[1] for s in shapes])
    hs = (ctypes.c_int32 * n_comp)(*[h for h, _ in geom.sampling])
    vs = (ctypes.c_int32 * n_comp)(*[v for _, v in geom.sampling])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.jt_fused_plane_decode(
        ptrs, rows, strides, hs, vs, n_comp, geom.h_max, geom.v_max,
        h_pad // (8 * geom.v_max), qtabs.data_ptr(),
        basis.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.data_ptr(),
        batch, h_pad, w_pad, mode, int(idct_mode == "approx"), stream)
    name = "K1a" if idct_mode == "approx" else "K1"
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    (LAUNCHES_APPROX if idct_mode == "approx" else LAUNCHES).add()
    return out


def kernel_attributes(idct_mode: str = "exact") -> dict:
    """K1's (or K1a's) compiled kernel on the card: registers a thread and
    local bytes a thread (spills)."""
    check_idct_mode(idct_mode)
    out = (ctypes.c_int32 * 2)()
    rc = load_kernel().jt_fused_plane_attributes(int(idct_mode == "approx"), out)
    if rc != 0:
        raise RuntimeError(f"K1 attribute query failed: CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1]}


def division_mismatches(lo: float = 2.0**-100, hi: float = 2.0**100,
                        device="cuda") -> tuple[int, float, float]:
    """On the card, every float x with lo <= |x| <= hi (powers of two) for
    which K1's fast x / 0.587 path differs from IEEE division (``__fdiv_rn``,
    the twin's ``/``): (count, smallest and largest such |x|, 0.0 if none).
    K1 takes the fast path only for x = 0 and 2^-100 <= |x| <= 2^100."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the division check runs on a CUDA device, not {dev}")
    bits = lambda x: int(np.array(x, np.float32).view(np.uint32))  # noqa: E731
    out = torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64, device=dev)
    rc = load_kernel().jt_divide_green_check(
        bits(lo), bits(hi), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"division check launch failed: CUDA error {rc}")
    count, packed = out.cpu().tolist()
    lo_hi = np.array([packed & 0xFFFFFFFF, packed >> 32], np.uint32).view(np.float32)
    return count, (float(lo_hi[0]) if count else 0.0), (float(lo_hi[1]) if count else 0.0)


def fused_plane_decode(planes, qtabs, geom, rounding: str = "truncate",
                       idct_mode: str = "exact") -> torch.Tensor:
    """K1 / K1a wrapper: the plain version for CPU tensors, the kernel for
    CUDA tensors (no fallback between them)."""
    if planes[0].device.type == "cpu":
        return fused_plane_decode_plain(planes, qtabs, geom, rounding,
                                        idct_mode)
    if planes[0].device.type == "cuda":
        return fused_plane_decode_cuda(planes, qtabs, geom, rounding,
                                       idct_mode)
    raise ValueError(f"K1 runs on cpu or cuda, not {planes[0].device}")


def decode_planes_fused(planes, plan, rounding: str = "truncate",
                        device="cuda", idct_mode: str = "exact") -> np.ndarray:
    """One image's int16 planes (native_decode_planes layout) -> RGB
    [H, W, 3] u8 on the host, through K1 (or K1a) on ``device``."""
    from jpeg_tpu_torch.models.decoder import PipelineGeometry

    geom = PipelineGeometry.of(plan)
    planes_t = [torch.as_tensor(p, device=device).unsqueeze(0) for p in planes]
    qtabs = torch.as_tensor(plan_quant_patterns(plan, geom),
                            device=device).unsqueeze(0)
    planar = fused_plane_decode(planes_t, qtabs, geom, rounding, idct_mode)
    return planar[0, :, : geom.height, : geom.width].permute(1, 2, 0).cpu().numpy()
