"""K2, the encoder's fused forward transform: planar RGB u8 -> quantized
int16 coefficient planes.

Counterpart of ``jpeg_tpu/ops/pallas_kernels.py`` (``fused_plane_encoder`` /
``_encode_kernel``, ``plan_inv_quant_patterns``). The CUDA kernel is
``csrc/fused_encode.cu``; :func:`fused_plane_encode_plain` is its plain
PyTorch twin, computing the same fp32 operations in the same order. The
order is the one the JAX kernel runs in on the CPU (interpret mode), where
XLA contracts multiply-adds into fused multiply-adds (``fma``, one
rounding):

1. colour: ``s = fma(k0, r, k1 * g); s = fma(k2, b, s)`` with the
   float32 constants of each row of the RGB->YCbCr matrix, then ``s - 128``
   for Y (gray: ``x - 128``);
2. chroma box mean, rows first, then columns, each as
   ``x0 * (1/f) + x1 * (1/f) + ...`` in ascending order (exact products,
   so fused or not gives the same sums);
3. vertical DCT pass ``t[u][x] = sum_y A[u][y] g[y][x]``: the y = 0 product,
   then one ``fma`` per y ascending;
4. horizontal pass ``c[u][v] = sum_x t[u][x] A[v][x]``, likewise over x;
5. ``c * iq``, round half to even, clamp to +-32767, int16.

The output planes are in the padded layout of
:func:`jpeg_tpu_torch.ops.fused_plane.padded_plane_shapes`, the layout the
C++ entropy encoder reads. :func:`fused_plane_encode` takes the plain
version only for tensors on the CPU. For CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from jpeg_tpu_torch.ops.fused_plane import padded_plane_shapes, padded_size
from jpeg_tpu_torch.ops.idct import dct_basis_1d
from jpeg_tpu_torch.ops.zigzag import unzigzag
from jpeg_tpu_torch.utils.build import LaunchCounter, load_cuda_kernel

LAUNCHES = LaunchCounter()

# RGB -> YCbCr rows as the TPU kernel writes them (pallas_kernels.py:432-434),
# rounded to float32 as JAX rounds its weakly typed constants; a subtracted
# term carries its sign here.
_COLOUR = [[float(np.float32(c)) for c in row] for row in (
    (0.299, 0.587, 0.114),
    (-0.168735892, -0.331264108, 0.5),
    (0.5, -0.418687589, -0.081312411),
)]


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with a single rounding, as ``__fmaf_rn`` and
    XLA's contracted CPU code compute it. The product is exact in float64;
    the sum is rounded to odd there (its exact residual from TwoSum), so the
    final rounding to float32 is the only one that counts."""
    p = torch.as_tensor(a).double() * torch.as_tensor(b).double()
    c = torch.as_tensor(c).double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    odd = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return odd.view(torch.float64).float()


def plan_inv_quant_tables(quant_tables_zz) -> np.ndarray:
    """[n_comp, 64] f32 natural-order reciprocal quant tables, one per
    component, from its zigzag-order table: ``1 / q`` as a float32 division,
    as ``plan_inv_quant_patterns`` builds it (K2 indexes the 8x8 table where
    the TPU kernel reads a tiled pattern)."""
    return np.stack([
        np.float32(1.0) / unzigzag(np.asarray(q, dtype=np.float32).reshape(64))
        for q in quant_tables_zz])


def _check_inputs(rgb, iqtabs, geom) -> int:
    n_comp = len(geom.sampling)
    if n_comp not in (1, 3):
        raise ValueError(f"K2 takes 1 or 3 components, got {n_comp}")
    if geom.h_max not in (1, 2, 4) or geom.v_max not in (1, 2, 4):
        raise ValueError(f"K2 takes sampling factors 1, 2 or 4, got "
                         f"{geom.sampling}")
    h_pad, w_pad = padded_size(geom)
    if rgb.dtype != torch.uint8 or rgb.dim() != 4 or tuple(rgb.shape[1:]) != (
            n_comp, h_pad, w_pad):
        raise ValueError(
            f"rgb must be uint8 [B, {n_comp}, {h_pad}, {w_pad}], got "
            f"{rgb.dtype} {tuple(rgb.shape)}")
    batch = rgb.shape[0]
    if iqtabs.dtype != torch.float32 or tuple(iqtabs.shape) != (batch, n_comp, 64):
        raise ValueError(f"iqtabs must be float32 [{batch}, {n_comp}, 64], got "
                         f"{iqtabs.dtype} {tuple(iqtabs.shape)}")
    return batch


def _colour_planes(x: torch.Tensor) -> list[torch.Tensor]:
    """[B, C, H, W] f32 -> per-component [B, H, W] level-shifted planes."""
    if x.shape[1] == 1:
        return [x[:, 0] - 128.0]
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    planes = []
    for ci, (kr, kg, kb) in enumerate(_COLOUR):
        p = _fma(kb, b, _fma(kr, r, g * kg))
        planes.append(p - 128.0 if ci == 0 else p)
    return planes


def _box_mean(x: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """Box mean of [B, H, W] over fy rows, then fx columns, summed in
    ascending order with each term scaled by 1/f first."""
    batch, rows, cols = x.shape
    if fy > 1:
        v = x.view(batch, rows // fy, fy, cols)
        acc = v[:, :, 0] * (1.0 / fy)
        for k in range(1, fy):
            acc = acc + v[:, :, k] * (1.0 / fy)
        x, rows = acc, rows // fy
    if fx > 1:
        v = x.reshape(batch, rows, cols // fx, fx)
        acc = v[..., 0] * (1.0 / fx)
        for k in range(1, fx):
            acc = acc + v[..., k] * (1.0 / fx)
        x = acc
    return x


def fused_plane_encode_plain(rgb, iqtabs, geom) -> list[torch.Tensor]:
    """Plain PyTorch K2. ``rgb``: edge-padded planar u8 [B, n_comp, H_pad,
    W_pad] (:func:`padded_size`); ``iqtabs``: f32 [B, n_comp, 64] natural
    order. Returns per-component int16 [B, rows_c, stride_c]
    (:func:`padded_plane_shapes`)."""
    _check_inputs(rgb, iqtabs, geom)
    a = torch.tensor(dct_basis_1d(), dtype=torch.float32, device=rgb.device)
    out = []
    for ci, (plane, (h, v)) in enumerate(zip(_colour_planes(rgb.to(torch.float32)),
                                             geom.sampling)):
        g = _box_mean(plane, geom.v_max // v, geom.h_max // h)
        batch, rows, cols = g.shape
        g = g.view(batch, rows // 8, 8, cols // 8, 8)
        t = a[:, 0].view(1, 1, 8, 1, 1) * g[:, :, 0:1]
        for y in range(1, 8):
            t = _fma(a[:, y].view(1, 1, 8, 1, 1), g[:, :, y:y + 1], t)
        c = t[..., 0:1] * a[:, 0]
        for x in range(1, 8):
            c = _fma(t[..., x:x + 1], a[:, x], c)
        q = torch.round(c * iqtabs[:, ci].view(batch, 1, 8, 1, 8))
        out.append(q.clamp(-32767.0, 32767.0).to(torch.int16)
                   .view(batch, rows, cols))
    return out


def _configure(lib) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.jt_fused_encode.restype = ctypes.c_int
    lib.jt_fused_encode.argtypes = [
        vp, ctypes.POINTER(vp), ctypes.POINTER(i64),
        ctypes.POINTER(i32), ctypes.POINTER(i32),  # rgb, planes, strides, h, v
        i32, i32, i32, i32,  # n_comp, h_max, v_max, MCU rows of H_pad
        vp, ctypes.POINTER(ctypes.c_float),  # iqtab, basis (host)
        i64, i64, i64, vp,  # batch, h_pad, w_pad, stream
    ]


def load_kernel():
    """Build (at first use) and load the K2 library. ``--fmad=false`` keeps
    nvcc from contracting any multiply-add the source does not fuse itself
    (``__fmaf_rn``)."""
    return load_cuda_kernel("fused_encode", ("--fmad=false",), _configure)


def fused_plane_encode_cuda(rgb, iqtabs, geom) -> list[torch.Tensor]:
    """Launch K2 on the current stream. Same contract as
    :func:`fused_plane_encode_plain`; both tensors must be on one CUDA
    device and contiguous, and ``rgb`` 16-byte aligned (the kernel loads 16
    pixels of a channel at a time)."""
    batch = _check_inputs(rgb, iqtabs, geom)
    dev = rgb.device
    if iqtabs.device != dev or not (rgb.is_contiguous() and iqtabs.is_contiguous()):
        raise ValueError("K2 inputs must be contiguous and on one device")
    if rgb.data_ptr() % 16:
        raise ValueError("K2's rgb must start on a 16-byte boundary")
    lib = load_kernel()
    shapes = padded_plane_shapes(geom)
    n_comp = len(shapes)
    h_pad, w_pad = padded_size(geom)
    basis = np.ascontiguousarray(dct_basis_1d(), np.float32)
    # 16-byte aligned rows (strides are multiples of 64 int16): the kernel
    # stores eight coefficients at a time.
    planes = [torch.empty((batch, *s), dtype=torch.int16, device=dev)
              for s in shapes]
    ptrs = (ctypes.c_void_p * n_comp)(*[p.data_ptr() for p in planes])
    strides = (ctypes.c_int64 * n_comp)(*[s[1] for s in shapes])
    hs = (ctypes.c_int32 * n_comp)(*[h for h, _ in geom.sampling])
    vs = (ctypes.c_int32 * n_comp)(*[v for _, v in geom.sampling])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.jt_fused_encode(
        rgb.data_ptr(), ptrs, strides, hs, vs, n_comp, geom.h_max, geom.v_max,
        h_pad // (8 * geom.v_max), iqtabs.data_ptr(),
        basis.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        batch, h_pad, w_pad, stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {rc}")
    LAUNCHES.add()
    return planes


def fused_plane_encode(rgb, iqtabs, geom) -> list[torch.Tensor]:
    """K2 wrapper: the plain version for CPU tensors, the kernel for CUDA
    tensors (no fallback between them)."""
    if rgb.device.type == "cpu":
        return fused_plane_encode_plain(rgb, iqtabs, geom)
    if rgb.device.type == "cuda":
        return fused_plane_encode_cuda(rgb, iqtabs, geom)
    raise ValueError(f"K2 runs on cpu or cuda, not {rgb.device}")
