"""Corpus decode: host entropy workers and a device entropy thread feeding K1.

Counterparts of ``jpeg_tpu.parallel.pipeline``'s ``CorpusDecoder`` (a thread
pool over the single-image decode, compat or fast path) and
``BatchedCorpusDecoder``. In the latter, images are parsed and
entropy-decoded on host threads (the C++ runtime releases the GIL) into
int16 coefficient planes, whatever their entropy coding, grouped by
geometry, and each group runs through one K1 launch (K1a with
``idct_mode="approx"``). RGB-direct, CMYK, YCCK, 12-bit and lossless
images, which K1 does not take, are decoded inline by their worker through
the compat path on the decoder's device (12-bit and lossless frames keep
their ``uint16`` samples), as in the JAX package.

With a ``mesh`` (:mod:`jpeg_tpu_torch.parallel.mesh`) each bucket's K1
launch is split over the mesh's ``data`` axis
(``decode_batch_fast(mesh=...)``); the frames that the mesh's size does
not divide go unsharded to the decoder's device, as in the JAX package.
Entropy decode, K3's device thread and the inline compat route stay on
the decoder's device.

With ``hybrid_device=True`` a device thread also claims batches from the
back of the work list and decodes their entropy with K3
(``entropy/device_window.py::decode_coefficients_device5_batch``) while the
host threads drain the front. Only three things send a claimed image to the
host route: a per-lane error bit, a plan the device route does not take
(:meth:`BatchedCorpusDecoder._device_eligible`: progressive, arithmetic,
RGB-direct, CMYK and YCCK plans among them), and a batch whose Huffman
tables or slot structure differ (``BatchMismatch``, raised before launch). Any
other failure (a kernel that does not build, a launch or CUDA error) raises
out of :meth:`BatchedCorpusDecoder.decode_all`.

Per-image isolation: an image that cannot be decoded becomes an error
record and never stops the corpus. A build, launch or CUDA failure (any
``RuntimeError``, ``NotImplementedError`` for a dtype with no CUDA kernel
among them) is not the image's fault and raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from jpeg_tpu_torch.entropy import device_huffman, device_window
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.models.decoder import (
    PipelineGeometry,
    coefficient_planes_from_blocks,
    decode_plan,
    decode_plan_fast,
    fast_path_takes,
    host_planes,
)
from jpeg_tpu_torch.ops.fused_plane import check_idct_mode, plan_quant_patterns
from jpeg_tpu_torch.parallel.batch import decode_batch_fast

# Images per device claim. A 4K frame with a restart marker per MCU row has
# 135 lanes, so 8 frames give K3 1,080 lanes.
DEVICE_BATCH = 8


@dataclasses.dataclass
class DecodeResult:
    path: str
    rgb: np.ndarray | None
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


def _name(item) -> str:
    return item if isinstance(item, str) else "<bytes>"


def _read(item) -> bytes:
    if isinstance(item, str):
        with open(item, "rb") as f:
            return f.read()
    return item


def _error_text(e: Exception) -> str:
    """The error record of an image that failed; re-raises a failure that
    is not the image's (a build, launch or CUDA error)."""
    if isinstance(e, RuntimeError):
        raise e
    return f"{type(e).__name__}: {e}"


class CorpusDecoder:
    """Thread-pooled single-image decode of many JPEGs on ``device``.

    ``path="compat"`` runs :func:`~jpeg_tpu_torch.models.decoder.decode_plan`
    per image, ``path="fast"``
    :func:`~jpeg_tpu_torch.models.decoder.decode_plan_fast` (K1, or K1a
    with ``idct_mode="approx"``, for gray and YCbCr streams, compat for the
    others). The pool persists across calls.
    """

    def __init__(self, workers: int | None = None, path: str = "compat",
                 rounding: str = "truncate", idct_mode: str = "exact",
                 device="cuda"):
        if path not in ("compat", "fast"):
            raise ValueError(f"unknown path {path!r}")
        check_idct_mode(idct_mode)
        self.workers = workers or os.cpu_count() or 1
        self.path = path
        self.rounding = rounding
        self.idct_mode = idct_mode
        self.device = torch.device(device)
        self._pool = None

    def close(self) -> None:
        """Shut down the worker threads (idle between calls)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        self._pool = None

    def _get_pool(self):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.workers)
        return self._pool

    def _decode_one(self, item) -> DecodeResult:
        try:
            plan = parse_jpeg(_read(item))
            if self.path == "fast":
                rgb = decode_plan_fast(plan, self.rounding, self.device,
                                       self.idct_mode)
            else:
                rgb = decode_plan(plan, self.rounding, device=self.device)
            return DecodeResult(_name(item), rgb)
        except Exception as e:  # noqa: BLE001 — per-image isolation boundary
            return DecodeResult(_name(item), None, error=_error_text(e))

    def decode_all(self, items) -> list[DecodeResult]:
        """Decode a list of paths or byte strings; order preserved."""
        return list(self._get_pool().map(self._decode_one, items))

    def decode_iter(self, items):
        """:meth:`decode_all` as a generator, for streaming consumers."""
        yield from self._get_pool().map(self._decode_one, items)


class BatchedCorpusDecoder:
    """Geometry-bucketed corpus decode on ``device``; each bucket through one
    K1 launch, or K1a with ``idct_mode="approx"`` (entropy decode and the
    inline compat route stay exact). With ``mesh``, one launch per data
    shard for the largest multiple of the mesh's size in each bucket, and
    one unsharded launch on ``device`` for the rest.

    Counters (cumulative over :meth:`decode_all` calls): ``device_frames``
    decoded by K3, ``fallback_frames`` claimed by the device thread but sent
    to the host route, ``entropy_launches`` (K3) and ``pixel_launches`` (K1
    or K1a, one a data shard under a mesh) made through this decoder.
    ``routes`` holds, per item of the last :meth:`decode_all`, the route its
    entropy took: ``"host"``, ``"device"`` (K3) or ``"fallback"`` (claimed
    by the device thread, then decoded on the host).
    """

    def __init__(self, workers: int | None = None, rounding: str = "truncate",
                 hybrid_device: bool = False, device_batch: int | None = None,
                 idct_mode: str = "exact", device="cuda", mesh=None):
        check_idct_mode(idct_mode)
        self.mesh = mesh
        self.idct_mode = idct_mode
        self.workers = workers or os.cpu_count() or 1
        self.rounding = rounding
        self.hybrid_device = hybrid_device
        self.device_batch = device_batch or DEVICE_BATCH
        self.device = torch.device(device)
        self.device_frames = 0
        self.fallback_frames = 0
        self.entropy_launches = 0
        self.pixel_launches = 0
        self.routes: list[str] = []
        # Persistent pools: fresh threads per call would bring fresh native
        # scratch buffers and allocator arenas each time.
        self._pool = None
        self._dev_pool = None

    def close(self) -> None:
        """Shut down the worker threads (idle between decode_all calls)."""
        for pool in (self._pool, self._dev_pool):
            if pool is not None:
                pool.shutdown(wait=True)
        self._pool = self._dev_pool = None

    def _pools(self):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.workers)
            self._dev_pool = ThreadPoolExecutor(max_workers=1)
        return self._pool, self._dev_pool

    def _entropy_one(self, item):
        """Host route -> (name, plan, geom, planes, error). Plans K1 does
        not take (another colour model, 12-bit, lossless) are decoded here
        through the compat path on ``self.device``: geom is then
        ``"compat"`` and planes the image."""
        try:
            plan = parse_jpeg(_read(item))
            if not fast_path_takes(plan):
                rgb = decode_plan(plan, self.rounding, device=self.device)
                return (_name(item), plan, "compat", rgb, None)
            # The runtime hands back this thread's scratch buffers: copy
            # before the thread decodes another same-geometry image, or the
            # stored planes are overwritten (a flake the JAX package met in
            # its hybrid corpus test). Baseline Huffman decodes on this
            # thread alone; progressive and arithmetic decodes take the cpu
            # count's threads, as in the JAX package.
            planes = [p.copy() for p in host_planes(plan, n_threads=1)]
            return (_name(item), plan, PipelineGeometry.of(plan), planes,
                    None)
        except Exception as e:  # noqa: BLE001 — per-image isolation boundary
            return (_name(item), None, None, None, _error_text(e))

    @staticmethod
    def _device_eligible(plan) -> bool:
        """Plans K3 takes: 8-bit baseline Huffman YCbCr/gray with at least
        two restart segments that cover every MCU."""
        return (not plan.lossless and not plan.arith_code
                and not plan.progressive and plan.precision == 8
                and plan.color_model in ("ycbcr", "gray")
                and len(plan.segments) >= 2
                and sum(s.mcu_count for s in plan.segments) == plan.n_mcus)

    def _hybrid_parse(self, items):
        parsed: list = [None] * len(items)
        routes = self.routes = ["host"] * len(items)
        work = deque(range(len(items)))
        lk = threading.Lock()
        k = self.device_batch

        def pop_front():
            with lk:
                return work.popleft() if work else None

        def pop_back_batch():
            # Tail guard: with one launch in flight the device holds up to
            # two claims, so leave the host at least two batches of work.
            with lk:
                if len(work) >= 3 * k:
                    return [work.pop() for _ in range(k)]
                return None

        def host_worker():
            while (i := pop_front()) is not None:
                parsed[i] = self._entropy_one(items[i])

        def to_host(idxs):
            with lk:
                self.fallback_frames += len(idxs)
            for i in idxs:
                routes[i] = "fallback"
                parsed[i] = self._entropy_one(items[i])

        def finalize(pend):
            idxs, plans, coeffs, err = pend
            err = err.cpu().numpy()  # waits for this launch
            off = 0
            for i, p, c in zip(idxs, plans, coeffs):
                seg_err = bool(err[off : off + len(p.segments)].any())
                off += len(p.segments)
                if seg_err:
                    to_host([i])
                    continue
                geom = PipelineGeometry.of(p)
                planes = [x.cpu().numpy()
                          for x in coefficient_planes_from_blocks(c, geom)]
                parsed[i] = (_name(items[i]), p, geom, planes, None)
                routes[i] = "device"
                with lk:
                    self.device_frames += 1

        def claim_plans(idxs):
            """Parse a claim; images the device does not take go to the host
            route. Returns (indices, plans) for the device."""
            keep, plans, host = [], [], []
            for i in idxs:
                try:
                    plan = parse_jpeg(_read(items[i]))
                except Exception:  # noqa: BLE001 — bad input, not a device
                    # failure: the host route's isolation boundary records it
                    host.append(i)
                    continue
                if self._device_eligible(plan):
                    keep.append(i)
                    plans.append(plan)
                else:
                    host.append(i)
            to_host(host)
            return keep, plans

        def device_side():
            on_cuda = self.device.type == "cuda"
            stream = torch.cuda.Stream(self.device) if on_cuda else None
            ctx = torch.cuda.stream(stream) if on_cuda else contextlib.nullcontext()
            pending = None
            with ctx:
                while (idxs := pop_back_batch()) is not None:
                    idxs, plans = claim_plans(idxs)
                    if not plans:
                        continue
                    try:
                        coeffs, err = (
                            device_window.decode_coefficients_device5_batch(
                                plans, self.device, to_host=False))
                    except device_huffman.BatchMismatch:  # before launch
                        to_host(idxs)
                        continue
                    with lk:
                        self.entropy_launches += 1
                    # One launch in flight: finalize the previous claim only
                    # after this one is queued.
                    if pending is not None:
                        finalize(pending)
                    pending = (idxs, plans, coeffs, err)
                if pending is not None:
                    finalize(pending)

        pool, dev_pool = self._pools()
        dev_fut = dev_pool.submit(device_side)
        host_futs = [pool.submit(host_worker) for _ in range(self.workers)]
        for f in host_futs:
            f.result()
        dev_fut.result()
        return parsed

    def decode_all(self, items) -> list[DecodeResult]:
        """Decode a list of paths or byte strings; order preserved."""
        if self.hybrid_device:
            parsed = self._hybrid_parse(items)
        else:
            pool, _ = self._pools()
            parsed = list(pool.map(self._entropy_one, items))
            self.routes = ["host"] * len(items)

        results: list = [None] * len(parsed)
        buckets: dict = {}
        for i, (name, plan, geom, planes, err) in enumerate(parsed):
            if err is not None:
                results[i] = DecodeResult(name, None, error=err)
            elif geom == "compat":  # decoded inline by its worker
                results[i] = DecodeResult(name, planes)
            else:
                buckets.setdefault(geom, []).append(i)
        for geom, idxs in buckets.items():
            # A mesh takes a multiple of its size (the JAX package's rule);
            # the rest of the bucket is decoded unsharded.
            spill_from = (len(idxs) - len(idxs) % self.mesh.size
                          if self.mesh else len(idxs))
            for chunk, mesh in ((idxs[:spill_from], self.mesh),
                                (idxs[spill_from:], None)):
                if chunk:
                    self._pixel_stage(parsed, results, geom, chunk, mesh)
        return results

    def _pixel_stage(self, parsed, results, geom, idxs, mesh) -> None:
        """K1 over one bucket's frames ``idxs``, on ``mesh`` or unsharded."""
        bp = [np.stack([parsed[i][3][c] for i in idxs])
              for c in range(len(geom.sampling))]
        bq = np.stack([plan_quant_patterns(parsed[i][1], geom) for i in idxs])
        planar = decode_batch_fast(bp, bq, geom, self.rounding, self.device,
                                   self.idct_mode, mesh=mesh)
        self.pixel_launches += mesh.shape["data"] if mesh else 1
        rgb = (planar[:, :, : geom.height, : geom.width]
               .permute(0, 2, 3, 1).contiguous().cpu().numpy())
        for b, i in enumerate(idxs):
            results[i] = DecodeResult(parsed[i][0], rgb[b])
