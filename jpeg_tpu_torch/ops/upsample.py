"""Plane assembly and replicate chroma upsampling, on torch tensors.

Copies of ``jpeg_tpu/ops/upsample.py``'s ``assemble_plane``,
``upsample_replicate`` and ``component_plane`` for the compat decode
(``models/decoder.py::decode_plan``). Parity: the reference's block
placement and pixel-replication upsample (``src/jpeg/decoder.rs:259-379``):
the MCU-interleaved block stream maps onto the component plane with one
reshape and permute, and an integer upsample is ``repeat_interleave``.
"""

from __future__ import annotations

import torch


def assemble_plane(blocks: torch.Tensor, mcus_y: int, mcus_x: int,
                   v: int, h: int) -> torch.Tensor:
    """[n_mcu * v * h, 8, 8] blocks in MCU stream order -> plane
    [mcus_y * v * 8, mcus_x * h * 8].

    Stream order (JPEG A.2.3): MCUs row-major; within an MCU a component's
    v * h blocks are row-major."""
    x = blocks.reshape(mcus_y, mcus_x, v, h, 8, 8)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [mcus_y, v, 8, mcus_x, h, 8]
    return x.reshape(mcus_y * v * 8, mcus_x * h * 8)


def upsample_replicate(plane: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """Pixel-replication upsample by integer factors (each sample fx x fy
    times)."""
    if fy > 1:
        plane = plane.repeat_interleave(fy, dim=0)
    if fx > 1:
        plane = plane.repeat_interleave(fx, dim=1)
    return plane


def component_plane(blocks: torch.Tensor, mcus_y: int, mcus_x: int,
                    v: int, h: int, v_max: int, h_max: int,
                    height: int, width: int,
                    upsample: str = "replicate") -> torch.Tensor:
    """Assemble, upsample to full resolution, crop to [height, width].
    Only ``upsample="replicate"`` (the reference's) is ported."""
    if upsample != "replicate":
        from jpeg_tpu_torch.models.decoder import not_ported

        raise not_ported(f"upsample={upsample!r}", 1)
    plane = assemble_plane(blocks, mcus_y, mcus_x, v, h)
    plane = upsample_replicate(plane, v_max // v, h_max // h)
    return plane[:height, :width]
