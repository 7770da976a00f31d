"""K5 and K6, the bare dequant + 8x8 IDCT: int16 [rows, cols] -> f32.

Counterparts of ``jpeg_tpu/ops/pallas_kernels.py`` ``idct_only_kernel`` (K5,
the sandwich formulation) and ``idct_only_kernel_roll`` (K6, 15 shift+mask
passes per axis, ``idct_roll_tile``), with host copies of
``quant_pattern``, ``roll_mask_vector`` and ``roll_masks``. They are the
roofline instrument of the JAX bench (``bench_idct_roofline``: 8x8 blocks/s
against the speed of light at 2 B in + 4 B out per pixel), not a stage of a
decode path.

The CUDA kernels are one templated body in ``csrc/idct_only.cu``. Each
plain PyTorch twin is its kernel's definition, every product rounded (no
fused multiply-add):

- :func:`idct_only_plain`: dequant, a vertical pass, a horizontal pass, each
  summing its eight terms in ascending order from the first product;
- :func:`idct_only_roll_plain`: the literal shift-and-mask passes of
  ``idct_roll_tile`` with ``torch.roll`` inside each [128, 256] tile, each
  summing 15 terms from +0.

The masked terms add exact zeros, so the two agree by value and differ only
in the sign of a zero (K6 never gives -0); the kernels reproduce each twin
bit for bit.

:func:`idct_only` and :func:`idct_only_roll` take the plain version only for
tensors on the CPU. For CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from jpeg_tpu_torch.ops.idct import dct_basis_1d, idct_blocks_plain
from jpeg_tpu_torch.ops.zigzag import unzigzag
from jpeg_tpu_torch.utils.build import LaunchCounter, load_cuda_kernel

TILE_W = 256    # columns of one TPU grid cell, and of the dequant pattern
BAND_ROWS = 128  # rows of one TPU grid cell, and of the dequant pattern

LAUNCHES = LaunchCounter()       # K5
LAUNCHES_ROLL = LaunchCounter()  # K6


def quant_pattern(quant_zz, rows: int, cols: int) -> np.ndarray:
    """Tile the natural-order 8x8 quant table over a [rows, cols] tile."""
    qnat = unzigzag(np.asarray(quant_zz, dtype=np.float32).reshape(64)).reshape(8, 8)
    return np.tile(qnat, (rows // 8, cols // 8))


def roll_mask_vector(n: int, d: int, transpose_a: bool = False) -> np.ndarray:
    """[n] f32 with entry i = A[i%8 + d, i%8] (or A[i%8, i%8 + d] for the
    forward DCT) when 0 <= i%8 + d < 8, else 0: the shift-d diagonal of the
    per-8-block 1-D DCT basis."""
    a = dct_basis_1d()
    out = np.zeros(n, np.float32)
    for i in range(n):
        x = i % 8
        u = x + d
        if 0 <= u < 8:
            out[i] = a[x, u] if transpose_a else a[u, x]
    return out


def roll_masks(rows: int, cols: int, forward: bool = False):
    """(mrow [rows, 128], mcol [16, cols]): column / row ``d + 7`` holds the
    shift-d mask (the TPU pads the minor dims to 128 and 16)."""
    mrow = np.zeros((rows, 128), np.float32)
    mcol = np.zeros((16, cols), np.float32)
    for d in range(-7, 8):
        mrow[:, d + 7] = roll_mask_vector(rows, d, transpose_a=forward)
        mcol[d + 7, :] = roll_mask_vector(cols, d, transpose_a=forward)
    return mrow, mcol


def check_shape(rows: int, cols: int) -> None:
    """The TPU grid's shape rule: whole [128, 256] cells."""
    if rows <= 0 or cols <= 0 or rows % BAND_ROWS or cols % TILE_W:
        raise ValueError(f"IDCT plane [{rows}, {cols}] must be whole "
                         f"[{BAND_ROWS}, {TILE_W}] cells")


def _check(x: torch.Tensor, qpat: torch.Tensor) -> None:
    if x.dtype != torch.int16 or x.dim() != 2:
        raise ValueError(f"x must be int16 [rows, cols], got {x.dtype} "
                         f"{list(x.shape)}")
    check_shape(*x.shape)
    if qpat.dtype != torch.float32 or tuple(qpat.shape) != (BAND_ROWS, TILE_W):
        raise ValueError(f"qpat must be float32 [{BAND_ROWS}, {TILE_W}], got "
                         f"{qpat.dtype} {list(qpat.shape)}")
    if qpat.device != x.device:
        raise ValueError("x and qpat must be on one device")


def _dequant(x: torch.Tensor, qpat: torch.Tensor) -> torch.Tensor:
    """x * qpat in fp32, over [rows / 128, 128, cols / 256, 256] tiles."""
    rows, cols = x.shape
    tiles = x.view(rows // BAND_ROWS, BAND_ROWS, cols // TILE_W, TILE_W)
    return tiles.to(torch.float32) * qpat.view(1, BAND_ROWS, 1, TILE_W)


def idct_only_plain(x: torch.Tensor, qpat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K5: int16 ``x [rows, cols]``, f32 ``qpat [128, 256]``
    (:func:`quant_pattern`, repeated over the plane) -> f32 [rows, cols]."""
    _check(x, qpat)
    rows, cols = x.shape
    f = _dequant(x, qpat).view(rows // 8, 8, cols // 8, 8)
    a = torch.tensor(dct_basis_1d(), dtype=torch.float32, device=x.device)
    return idct_blocks_plain(f, a).reshape(rows, cols)


def idct_only_roll_plain(x: torch.Tensor, qpat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K6: the same function as :func:`idct_only_plain` by
    ``idct_roll_tile``'s 15 shift+mask passes per axis, each shift a
    ``torch.roll`` within a [128, 256] tile (result[i] = x[i + d])."""
    _check(x, qpat)
    rows, cols = x.shape
    mrow, mcol = (torch.from_numpy(m).to(x.device)
                  for m in roll_masks(BAND_ROWS, TILE_W))
    f = _dequant(x, qpat)
    acc = torch.zeros_like(f)
    for d in range(-7, 8):
        acc = acc + mrow[:, d + 7].view(1, BAND_ROWS, 1, 1) * torch.roll(f, -d, 1)
    out = torch.zeros_like(f)
    for d in range(-7, 8):
        out = out + mcol[d + 7].view(1, 1, 1, TILE_W) * torch.roll(acc, -d, 3)
    return out.reshape(rows, cols)


def _configure(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    for fn in (lib.jt_idct_only, lib.jt_idct_only_roll):
        fn.restype = ctypes.c_int
        # x, qpat, basis (host), out, rows, cols, stream
        fn.argtypes = [vp, vp, ctypes.POINTER(ctypes.c_float), vp, i32, i32, vp]


def load_kernel():
    """Build (at first use) and load the K5/K6 library. ``--fmad=false``
    keeps nvcc from contracting the multiply-adds; the IDCT comes from
    ``csrc/idct8x8.cuh``, shared with K1."""
    return load_cuda_kernel("idct_only", ("--fmad=false",), _configure,
                            headers=("idct8x8.cuh",))


_BASIS = np.ascontiguousarray(dct_basis_1d(), np.float32)


def _launch(name: str, entry: str, x: torch.Tensor, qpat: torch.Tensor,
            counter: LaunchCounter) -> torch.Tensor:
    _check(x, qpat)
    if not (x.is_contiguous() and qpat.is_contiguous()):
        raise ValueError(f"{name} inputs must be contiguous")
    if x.data_ptr() % 16 or qpat.data_ptr() % 16:
        raise ValueError(f"{name} inputs must start on a 16-byte boundary")
    dev = x.device
    lib = load_kernel()
    rows, cols = x.shape
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    rc = getattr(lib, entry)(
        x.data_ptr(), qpat.data_ptr(),
        _BASIS.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.data_ptr(),
        rows, cols, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    counter.add()
    return out


def idct_only_cuda(x: torch.Tensor, qpat: torch.Tensor) -> torch.Tensor:
    """Launch K5 on the current stream; same contract as
    :func:`idct_only_plain`."""
    return _launch("K5", "jt_idct_only", x, qpat, LAUNCHES)


def idct_only_roll_cuda(x: torch.Tensor, qpat: torch.Tensor) -> torch.Tensor:
    """Launch K6 on the current stream; same contract as
    :func:`idct_only_roll_plain`."""
    return _launch("K6", "jt_idct_only_roll", x, qpat, LAUNCHES_ROLL)


def _dispatch(x, qpat, plain, cuda):
    if x.device.type == "cpu":
        return plain(x, qpat)
    if x.device.type == "cuda":
        return cuda(x, qpat)
    raise ValueError(f"K5/K6 run on cpu or cuda, not {x.device}")


def idct_only(x: torch.Tensor, qpat: torch.Tensor) -> torch.Tensor:
    """K5 wrapper: the plain version for CPU tensors, the kernel for CUDA
    tensors (no fallback between them)."""
    return _dispatch(x, qpat, idct_only_plain, idct_only_cuda)


def idct_only_roll(x: torch.Tensor, qpat: torch.Tensor) -> torch.Tensor:
    """K6 wrapper: the plain version for CPU tensors, the kernel for CUDA
    tensors (no fallback between them)."""
    return _dispatch(x, qpat, idct_only_roll_plain, idct_only_roll_cuda)


def _builder(rows: int, cols: int, wrapper):
    check_shape(rows, cols)

    def run(x, qpat):
        if tuple(x.shape) != (rows, cols):
            raise ValueError(f"built for [{rows}, {cols}], got {list(x.shape)}")
        return wrapper(x, qpat)

    return run


def idct_only_kernel(rows: int, cols: int):
    """K5 for a [rows, cols] plane -> ``run(x, qpat)``, as the JAX builder
    returns it. Raises ``ValueError`` unless rows % 128 == cols % 256 == 0."""
    return _builder(rows, cols, idct_only)


def idct_only_kernel_roll(rows: int, cols: int):
    """K6 for a [rows, cols] plane -> ``run(x, qpat)``; same contract as
    :func:`idct_only_kernel`."""
    return _builder(rows, cols, idct_only_roll)
