"""Batched dense stages: one kernel launch for a bucket of same-geometry
images.

Counterparts of ``jpeg_tpu.parallel.batch.decode_batch_fast`` (K1) and
``encode_batch_device`` (K2). The JAX versions vmap the Pallas kernel over
the batch; here the batch is a written out dimension of the kernel's grid.
Mesh sharding is not ported (ROADMAP.md, 'Still to port' item 8).
"""

from __future__ import annotations

import torch

from jpeg_tpu_torch.ops.fused_encode import fused_plane_encode
from jpeg_tpu_torch.ops.fused_plane import fused_plane_decode


def decode_batch_fast(planes_batch, qtabs_batch, geom,
                      rounding: str = "truncate",
                      device="cuda") -> torch.Tensor:
    """Per-component int16 planes [B, rows_c, stride_c] and natural-order
    f32 quant tables [B, n_comp, 64] (numpy arrays or tensors) -> planar u8
    [B, 3, H_pad, W_pad] on ``device``, through one K1 launch."""
    planes = [torch.as_tensor(p).to(device).contiguous() for p in planes_batch]
    qtabs = torch.as_tensor(qtabs_batch).to(device).contiguous()
    return fused_plane_decode(planes, qtabs, geom, rounding)


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
