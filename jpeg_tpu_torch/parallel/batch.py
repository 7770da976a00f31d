"""Batched dense stages: one launch or product for a bucket of
same-geometry images.

Counterparts of ``jpeg_tpu.parallel.batch``'s ``decode_batch`` (the compat
pipeline), ``decode_batch_fast`` (K1) and ``encode_batch_device`` (K2). The
JAX versions vmap over the batch; here the batch is a written out dimension
of the kernel's grid, or of the compat route's products. Mesh sharding is
not ported (ROADMAP.md, 'Still to port' item 8).
"""

from __future__ import annotations

import torch

from jpeg_tpu_torch.models.decoder import _pipeline, not_ported
from jpeg_tpu_torch.ops.fused_encode import fused_plane_encode
from jpeg_tpu_torch.ops.fused_plane import fused_plane_decode


def decode_batch(coeffs, matrices, geom, rounding: str = "truncate",
                 mesh=None, device="cuda") -> torch.Tensor:
    """The compat pipeline over a same-geometry batch: coeffs [B,
    total_blocks, 64] int32 (zigzag) and matrices [B, n_comp, 64, 64] f32
    (numpy arrays or tensors) -> RGB u8 [B, H, W, 3] on ``device``, with one
    batched fp32 ``torch.matmul`` per component for the whole batch."""
    if mesh is not None:
        raise not_ported("decode_batch(mesh=...)", 8)
    c = torch.as_tensor(coeffs).to(device)
    m = torch.as_tensor(matrices).to(device)
    return _pipeline(c, m, geom, rounding)


def decode_batch_fast(planes_batch, qtabs_batch, geom,
                      rounding: str = "truncate", device="cuda",
                      idct_mode: str = "exact") -> torch.Tensor:
    """Per-component int16 planes [B, rows_c, stride_c] and natural-order
    f32 quant tables [B, n_comp, 64] (numpy arrays or tensors) -> planar u8
    [B, 3, H_pad, W_pad] on ``device``, through one K1 launch (K1a with
    ``idct_mode="approx"``, the JAX function's DEFAULT-precision tier)."""
    planes = [torch.as_tensor(p).to(device).contiguous() for p in planes_batch]
    qtabs = torch.as_tensor(qtabs_batch).to(device).contiguous()
    return fused_plane_decode(planes, qtabs, geom, rounding, idct_mode)


def encode_batch_device(rgb_planar_batch, inv_qtabs_batch, geom,
                        device="cuda") -> list[torch.Tensor]:
    """Batched forward transform (the encoder's dense half) through one K2
    launch on ``device``.

    ``rgb_planar_batch``: [B, 3|1, H_pad, W_pad] u8, edge-padded planar;
    ``inv_qtabs_batch``: [B, n_comp, 64] f32 natural-order reciprocal quant
    tables (:func:`jpeg_tpu_torch.ops.fused_encode.plan_inv_quant_tables`;
    the JAX version takes tiled patterns). Numpy arrays or tensors. Returns
    per-component int16 coefficient planes [B, rows_c, stride_c] on
    ``device``, ready for the parallel entropy encoder."""
    rgb = torch.as_tensor(rgb_planar_batch).to(device).contiguous()
    iq = torch.as_tensor(inv_qtabs_batch).to(device).contiguous()
    return fused_plane_encode(rgb, iq, geom)
