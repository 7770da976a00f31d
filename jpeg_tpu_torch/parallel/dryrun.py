"""One small step of every sharded route over an (n_data, n_seg) mesh.

Counterpart of ``dryrun_multichip`` in the JAX repo's ``__graft_entry__.py``:

- ``decode_batch_rows_sp`` (compat, images over ``data``, MCU-row bands
  over ``seg``) on seeded coefficients;
- ``decode_batch_fast(mesh=)`` (K1 a data shard) on a frame encoded by the
  port;
- ``decode_batch_rows_sp_fast`` (K1 a band) on a taller frame;
- K3's batch tier against the NumPy oracle;
- ``BatchedCorpusDecoder(mesh=, hybrid_device=True, device_batch=3)``
  against ``decode_bytes(path="fast")``.

Each sharded output is also held to the unsharded route, bit for bit. Where
the JAX version skips a route whose native build is missing, here a missing
build, like any failed check, raises.
"""

from __future__ import annotations

import numpy as np
import torch

from jpeg_tpu_torch import runtime
from jpeg_tpu_torch.entropy.annex_k import QUANT_CHROMA, QUANT_LUMA
from jpeg_tpu_torch.entropy.device_window import (
    decode_coefficients_device5_batch,
)
from jpeg_tpu_torch.entropy.oracle import decode_coefficients
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.io.corpus import synthetic_image
from jpeg_tpu_torch.models.decoder import PipelineGeometry, decode_bytes
from jpeg_tpu_torch.models.encoder import encode_rgb
from jpeg_tpu_torch.ops.fused_plane import plan_quant_patterns
from jpeg_tpu_torch.ops.idct import fused_idct_matrix
from jpeg_tpu_torch.ops.zigzag import zigzag
from jpeg_tpu_torch.parallel.batch import (
    decode_batch,
    decode_batch_fast,
    decode_batch_rows_sp,
    decode_batch_rows_sp_fast,
)
from jpeg_tpu_torch.parallel.mesh import make_mesh
from jpeg_tpu_torch.parallel.pipeline import BatchedCorpusDecoder


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _example_inputs(mcus_x: int, mcus_y: int, batch: int, seed: int = 0):
    """A 4:2:0 geometry of whole MCUs, seeded zigzag coefficients [batch,
    total_blocks, 64] int32 and the Annex K tables' fused matrices."""
    geom = PipelineGeometry(width=mcus_x * 16, height=mcus_y * 16,
                            mcus_x=mcus_x, mcus_y=mcus_y, h_max=2, v_max=2,
                            sampling=((2, 2), (1, 1), (1, 1)))
    rng = np.random.default_rng(seed)
    coeffs = rng.integers(-64, 64, (batch, geom.total_blocks, 64)).astype(
        np.int32)
    mats = np.stack([fused_idct_matrix(zigzag(QUANT_LUMA)),
                     fused_idct_matrix(zigzag(QUANT_CHROMA)),
                     fused_idct_matrix(zigzag(QUANT_CHROMA))])
    return geom, coeffs, np.broadcast_to(mats, (batch,) + mats.shape).copy()


def _frame(width: int, height: int, seed: int) -> bytes:
    """A seeded 4:2:0 q85 frame with a restart marker per MCU row."""
    return encode_rgb(synthetic_image(width, height, seed=seed), quality=85,
                      subsampling=(2, 2), restart_interval_mcus=-(-width // 16))


def _fast_inputs(data: bytes, batch: int):
    """K1's inputs for ``batch`` copies of one frame: planes, tables, geom."""
    plan = parse_jpeg(data)
    geom = PipelineGeometry.of(plan)
    planes = [np.broadcast_to(p, (batch,) + p.shape).copy()
              for p in runtime.native_decode_planes(plan)]
    qtabs = np.broadcast_to(plan_quant_patterns(plan, geom),
                            (batch, len(planes), 64)).copy()
    return planes, qtabs, geom


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run every sharded route once over an (n_data, n_seg) mesh of the
    first ``n_devices`` of ``devices`` (default: every visible CUDA device;
    a list may name one device several times). ``n_seg`` is 2 where
    ``n_devices`` is even, else 1. Returns what ran."""
    if devices is None:
        devices = [d for row in make_mesh().devices for d in row]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    n_seg = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_seg
    mesh = make_mesh(n_data, n_seg, devices[:n_devices])
    data_mesh = make_mesh(n_data, 1, devices[:n_data])
    dev = mesh.first

    geom, coeffs, mats = _example_inputs(2, 2 * n_seg, 2 * n_data)
    rgb, frames = decode_batch_rows_sp(coeffs, mats, geom, mesh)
    _check(tuple(rgb.shape) == (2 * n_data, geom.height, geom.width, 3)
           and frames == 2 * n_data, f"rows_sp gave {tuple(rgb.shape)}, "
           f"{frames} frames")
    _check(torch.equal(rgb, decode_batch(coeffs, mats, geom, device=dev)),
           "rows_sp differs from the unsharded compat decode")

    planes, qtabs, fgeom = _fast_inputs(_frame(96, 64, seed=0), n_data)
    out = decode_batch_fast(planes, qtabs, fgeom, mesh=data_mesh)
    _check(torch.equal(out, decode_batch_fast(planes, qtabs, fgeom,
                                              device=dev)),
           "decode_batch_fast(mesh=) differs from the unsharded launch")
    if n_seg > 1:
        planes, qtabs, g2 = _fast_inputs(_frame(64, 16 * 16 * n_seg, seed=1),
                                         n_data)
        out2 = decode_batch_rows_sp_fast(planes, qtabs, g2, mesh)
        _check(torch.equal(out2, decode_batch_fast(planes, qtabs, g2,
                                                   device=dev)),
               "rows_sp_fast differs from the unsharded launch")

    items = [encode_rgb(synthetic_image(96, 64, seed=i), quality=85,
                        subsampling=(2, 2), restart_interval_mcus=3)
             for i in range(2 * n_data + 1)]
    plans = [parse_jpeg(d) for d in items[:3]]
    got, err = decode_coefficients_device5_batch(plans, dev)
    _check(not err.any(), "K3 flagged a lane of a valid stream")
    for p, g in zip(plans, got):
        _check(np.array_equal(g, decode_coefficients(p)),
               "K3's coefficients differ from the oracle's")
    dec = BatchedCorpusDecoder(workers=2, mesh=data_mesh, hybrid_device=True,
                               device_batch=3, device=dev)
    try:
        results = dec.decode_all(items)
    finally:
        dec.close()
    _check(all(r.ok for r in results),
           f"hybrid corpus errors: {[r.error for r in results if not r.ok]}")
    for d, r in zip(items, results):
        _check(np.array_equal(r.rgb, decode_bytes(d, path="fast", device=dev)),
               "the hybrid corpus route under the mesh differs from "
               "decode_bytes(path='fast')")
    summary = {"mesh": (n_data, n_seg), "rgb_shape": tuple(rgb.shape),
               "frames": frames, "fast_shape": tuple(out.shape),
               "items": len(items), "device_frames": dec.device_frames,
               "pixel_launches": dec.pixel_launches}
    print(f"dryrun_multichip OK: mesh=({n_data} data, {n_seg} seg), "
          f"rgb {summary['rgb_shape']}, frames={frames}, fast-path batch "
          f"{summary['fast_shape']}, hybrid+K3 ok ({len(items)} imgs, "
          f"{dec.device_frames} decoded by K3, {len(plans)}-img K3 batch)")
    return summary
