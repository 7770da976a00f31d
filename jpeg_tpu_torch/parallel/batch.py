"""Batched pixel stage: one K1 launch for a bucket of same-geometry images.

Counterpart of ``jpeg_tpu.parallel.batch.decode_batch_fast``. The JAX
version vmaps the Pallas kernel over the batch; here the batch is a written
out dimension of the kernel's grid. Mesh sharding is not ported
(ROADMAP.md, 'Still to port' item 8).
"""

from __future__ import annotations

import torch

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
