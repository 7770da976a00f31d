"""Batched dense stages: one launch or product for a bucket of
same-geometry images, optionally sharded over a (data, seg) mesh.

Counterparts of ``jpeg_tpu.parallel.batch``: ``decode_batch`` (the compat
pipeline), ``decode_batch_with_metrics``, ``decode_batch_rows_sp``,
``decode_batch_fast`` (K1), ``decode_batch_rows_sp_fast`` (K1 per band)
and ``encode_batch_device`` (K2). The JAX versions vmap over the batch;
here the batch is a written out dimension of the kernel's grid, or of the
compat route's products.

With a ``mesh`` (:mod:`jpeg_tpu_torch.parallel.mesh`) the batch is split
over the ``data`` axis, each shard runs on its device (one launch or one
product set per shard; shards that share a device run one after the
other), and the result is gathered on the mesh's first device; the
``device`` argument is then not read. A batch that ``n_data`` does not
divide raises ``ValueError``, as a sharded JAX ``jit`` does. The
``_rows_sp`` functions also split each image into horizontal bands over
``seg``, each decoded with the band's own geometry: MCU rows are
independent in pixel space, so the bands join into the whole image. A
shard's failure raises; no shard falls back to another route.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from jpeg_tpu_torch.models.decoder import _pipeline
from jpeg_tpu_torch.ops.fused_encode import fused_plane_encode
from jpeg_tpu_torch.ops.fused_plane import band_mcus, fused_plane_decode
from jpeg_tpu_torch.parallel.distributed import aggregate_metrics
from jpeg_tpu_torch.parallel.mesh import data_sharding


def _on(device: torch.device):
    """Make ``device`` current, so that a kernel launches on its stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _bands(x: torch.Tensor, n_seg: int, dim: int, row) -> list[torch.Tensor]:
    """``x`` cut into ``n_seg`` equal slices along ``dim``, slice ``j`` on
    ``row[j]``."""
    return [s.to(d).contiguous() for s, d in
            zip(torch.chunk(x, n_seg, dim), row)]


def decode_batch(coeffs, matrices, geom, rounding: str = "truncate",
                 mesh=None, device="cuda") -> torch.Tensor:
    """The compat pipeline over a same-geometry batch: coeffs [B,
    total_blocks, 64] int32 (zigzag) and matrices [B, n_comp, 64, 64] f32
    (numpy arrays or tensors) -> RGB u8 [B, H, W, 3] on ``device`` (on the
    mesh's first device with ``mesh``), with one batched fp32
    ``torch.matmul`` per component for the whole batch or shard."""
    c = torch.as_tensor(coeffs)
    m = torch.as_tensor(matrices)
    if mesh is None:
        return _pipeline(c.to(device), m.to(device), geom, rounding)
    sharding = data_sharding(mesh, c.dim())
    return sharding.gather([
        _pipeline(cs, ms, geom, rounding)
        for cs, ms in zip(sharding.split(c), sharding.split(m))])


def decode_batch_with_metrics(coeffs, matrices, geom, mesh,
                              rounding: str = "truncate"):
    """:func:`decode_batch` over ``mesh`` that also counts what it decoded:
    (RGB [B, H, W, 3] u8 on the mesh's first device, frames, blocks). The
    counts are summed over the data shards, where the JAX version ``psum``s
    them over the mesh, and over the processes of a ``torch.distributed``
    group where one exists."""
    rgb = decode_batch(coeffs, matrices, geom, rounding, mesh)
    frames = rgb.shape[0]
    total = aggregate_metrics({"frames": frames,
                               "blocks": frames * geom.total_blocks})
    return rgb, int(total["frames"]), int(total["blocks"])


def decode_batch_rows_sp(coeffs, matrices, geom, mesh,
                         rounding: str = "truncate"):
    """The compat pipeline sharded over both mesh axes: images over
    ``data``, MCU-row bands of each image over ``seg``. Returns (RGB [B, H,
    W, 3] u8 on the mesh's first device, frames). Needs ``mcus_y`` divisible
    by ``n_seg`` and no partial bottom MCU row (``ValueError`` otherwise).
    The coefficients are in MCU-row-major stream order, so an even split of
    the block axis is a split into MCU-row bands."""
    n_seg = mesh.shape["seg"]
    if geom.mcus_y % n_seg or geom.height != geom.mcus_y * 8 * geom.v_max:
        raise ValueError(
            f"row sharding needs mcus_y ({geom.mcus_y}) divisible by n_seg "
            f"({n_seg}) and full MCU rows (height {geom.height})")
    local = dataclasses.replace(geom, mcus_y=geom.mcus_y // n_seg,
                                height=geom.height // n_seg)
    c = torch.as_tensor(coeffs)
    m = torch.as_tensor(matrices)
    sharding = data_sharding(mesh, c.dim())
    rgb = []
    for cs, ms, row in zip(sharding.split(c), sharding.split(m),
                           mesh.devices):
        bands = [_pipeline(cb, ms.to(d), local, rounding)
                 for cb, d in zip(_bands(cs, n_seg, 1, row), row)]
        rgb.append(torch.cat([b.to(row[0]) for b in bands], 1))
    frames = aggregate_metrics({"frames": c.shape[0]})["frames"]
    return sharding.gather(rgb), int(frames)


def decode_batch_fast(planes_batch, qtabs_batch, geom,
                      rounding: str = "truncate", device="cuda",
                      idct_mode: str = "exact", *, mesh=None) -> torch.Tensor:
    """Per-component int16 planes [B, rows_c, stride_c] and natural-order
    f32 quant tables [B, n_comp, 64] (numpy arrays or tensors) -> planar u8
    [B, 3, H_pad, W_pad] on ``device``, through one K1 launch (K1a with
    ``idct_mode="approx"``, the JAX function's DEFAULT-precision tier); with
    ``mesh``, one launch per data shard, gathered on the mesh's first
    device."""
    planes = [torch.as_tensor(p) for p in planes_batch]
    qtabs = torch.as_tensor(qtabs_batch)
    if mesh is None:
        return fused_plane_decode([p.to(device).contiguous() for p in planes],
                                  qtabs.to(device).contiguous(), geom,
                                  rounding, idct_mode)
    sharding = data_sharding(mesh, 3)
    shards = zip(*[sharding.split(p) for p in planes], sharding.split(qtabs))
    out = []
    for row, (*ps, qs) in zip(mesh.devices, shards):
        with _on(row[0]):
            out.append(fused_plane_decode(ps, qs, geom, rounding, idct_mode))
    return sharding.gather(out)


def decode_batch_rows_sp_fast(planes_batch, qtabs_batch, geom, mesh,
                              rounding: str = "truncate") -> torch.Tensor:
    """K1 sharded over both mesh axes: images over ``data``, horizontal
    bands of the coefficient planes over ``seg``, one launch per (data,
    seg) shard at the band's geometry. Returns planar u8 [B, 3, H_pad,
    W_pad] on the mesh's first device, the bands joined along H. Needs
    ``mcus_y`` divisible by ``band_mcus * n_seg``, so that each shard holds
    whole kernel bands (``ValueError`` otherwise)."""
    n_seg = mesh.shape["seg"]
    bm = band_mcus(geom)
    if geom.mcus_y % (bm * n_seg):
        raise ValueError(
            f"fast row sharding needs mcus_y ({geom.mcus_y}) divisible by "
            f"band_mcus*n_seg ({bm}*{n_seg})")
    local = dataclasses.replace(
        geom, mcus_y=geom.mcus_y // n_seg,
        height=(geom.mcus_y // n_seg) * 8 * geom.v_max)
    planes = [torch.as_tensor(p) for p in planes_batch]
    qtabs = torch.as_tensor(qtabs_batch)
    sharding = data_sharding(mesh, 3)
    shards = zip(*[sharding.split(p) for p in planes], sharding.split(qtabs))
    out = []
    for row, (*ps, qs) in zip(mesh.devices, shards):
        band_planes = zip(*[_bands(p, n_seg, 1, row) for p in ps])
        bands = []
        for d, bp in zip(row, band_planes):
            with _on(d):
                bands.append(fused_plane_decode(list(bp), qs.to(d), local,
                                                rounding))
        out.append(torch.cat([b.to(row[0]) for b in bands], 2))
    return sharding.gather(out)


def encode_batch_device(rgb_planar_batch, inv_qtabs_batch, geom,
                        device="cuda", *, mesh=None) -> list[torch.Tensor]:
    """Batched forward transform (the encoder's dense half) through one K2
    launch on ``device``, or one per data shard of ``mesh`` (the planes
    gathered on its first device).

    ``rgb_planar_batch``: [B, 3|1, H_pad, W_pad] u8, edge-padded planar;
    ``inv_qtabs_batch``: [B, n_comp, 64] f32 natural-order reciprocal quant
    tables (:func:`jpeg_tpu_torch.ops.fused_encode.plan_inv_quant_tables`;
    the JAX version takes tiled patterns). Numpy arrays or tensors. Returns
    per-component int16 coefficient planes [B, rows_c, stride_c], ready for
    the parallel entropy encoder."""
    rgb = torch.as_tensor(rgb_planar_batch)
    iq = torch.as_tensor(inv_qtabs_batch)
    if mesh is None:
        return fused_plane_encode(rgb.to(device).contiguous(),
                                  iq.to(device).contiguous(), geom)
    sharding = data_sharding(mesh, 3)
    out = []
    for row, rs, qs in zip(mesh.devices, sharding.split(rgb),
                           sharding.split(iq)):
        with _on(row[0]):
            out.append(fused_plane_encode(rs, qs, geom))
    return [sharding.gather(comp) for comp in zip(*out)]
