"""Plane assembly and chroma upsampling, on torch tensors.

Copies of ``jpeg_tpu/ops/upsample.py``'s ``assemble_plane``,
``upsample_replicate``, ``upsample_fancy`` and ``component_plane`` for the
compat decode (``models/decoder.py::decode_plan``). Parity: the reference's
block placement and pixel-replication upsample
(``src/jpeg/decoder.rs:259-379``): the MCU-interleaved block stream maps
onto the component plane with one reshape and permute, and an integer
upsample is ``repeat_interleave``. Leading batch dimensions pass through.
"""

from __future__ import annotations

import torch


def assemble_plane(blocks: torch.Tensor, mcus_y: int, mcus_x: int,
                   v: int, h: int) -> torch.Tensor:
    """[..., n_mcu * v * h, 8, 8] blocks in MCU stream order -> plane
    [..., mcus_y * v * 8, mcus_x * h * 8].

    Stream order (JPEG A.2.3): MCUs row-major; within an MCU a component's
    v * h blocks are row-major."""
    batch = blocks.shape[:-3]
    n = len(batch)
    x = blocks.reshape(*batch, mcus_y, mcus_x, v, h, 8, 8)
    # -> [..., mcus_y, v, 8, mcus_x, h, 8]
    x = x.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3, n + 5)
    return x.reshape(*batch, mcus_y * v * 8, mcus_x * h * 8)


def upsample_replicate(plane: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """Pixel-replication upsample by integer factors (each sample fx x fy
    times)."""
    if fy > 1:
        plane = plane.repeat_interleave(fy, dim=-2)
    if fx > 1:
        plane = plane.repeat_interleave(fx, dim=-1)
    return plane


def _fancy_axis(plane: torch.Tensor, axis: int) -> torch.Tensor:
    """2x triangular-filter upsample along one axis (libjpeg "fancy"):
    out[2i] = (3*c[i] + c[i-1]) / 4, out[2i+1] = (3*c[i] + c[i+1]) / 4,
    with edge replication."""
    x = plane.movedim(axis, 0)
    prev = torch.cat([x[:1], x[:-1]], dim=0)
    nxt = torch.cat([x[1:], x[-1:]], dim=0)
    even = (3.0 * x + prev) * 0.25
    odd = (3.0 * x + nxt) * 0.25
    out = torch.stack([even, odd], dim=1).reshape((-1,) + x.shape[1:])
    return out.movedim(0, axis)


def upsample_fancy(plane: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """Triangular-filter chroma upsample (libjpeg's default "fancy" mode).
    Only 2x factors get the filter; 4x is two 2x passes."""
    while fy > 1:
        plane = _fancy_axis(plane, -2)
        fy //= 2
    while fx > 1:
        plane = _fancy_axis(plane, -1)
        fx //= 2
    return plane


def component_plane(blocks: torch.Tensor, mcus_y: int, mcus_x: int,
                    v: int, h: int, v_max: int, h_max: int,
                    height: int, width: int,
                    upsample: str = "replicate") -> torch.Tensor:
    """Assemble, upsample to full resolution, crop to [height, width].
    ``upsample``: ``"replicate"`` (the reference's) or ``"fancy"``
    (libjpeg's triangular filter)."""
    plane = assemble_plane(blocks, mcus_y, mcus_x, v, h)
    if upsample == "fancy":
        plane = upsample_fancy(plane, v_max // v, h_max // h)
    elif upsample == "replicate":
        plane = upsample_replicate(plane, v_max // v, h_max // h)
    else:
        raise ValueError(f"unknown upsample {upsample!r}")
    return plane[..., :height, :width]
