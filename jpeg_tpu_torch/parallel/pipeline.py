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
(``entropy/device_huffman.py``: ``prepare_lane_batch``, then
``decode_prepared_batch``) while the host threads drain the front; its
first claim is taken before they start. Only three things send a claimed image to the
host route: a per-lane error bit, a plan the device route does not take
(:meth:`BatchedCorpusDecoder._device_eligible`: progressive, arithmetic,
RGB-direct, CMYK and YCCK plans among them), and a batch whose Huffman
tables or slot structure differ (``BatchMismatch``, raised before launch). Any
other failure (a kernel that does not build, a launch or CUDA error) raises
out of :meth:`BatchedCorpusDecoder.decode_all`.

K1's input is staged (:mod:`jpeg_tpu_torch.parallel.staging`): each
frame's planes go, as soon as they exist, into the next slot of a reused
buffer of their geometry, page-locked where the CUDA runtime allows, and a
run of a bucket's slots is K1's input as it stands, with no gather. K1's
output is pooled the same way: a bucket's cropped RGB comes down by DMA
into a reused page-locked buffer of its geometry, whose views are the
results, reused once the caller no longer holds them.

On a CUDA device without a mesh the pixel stage streams behind the
entropy phase: while the workers and the device thread decode, the caller
launches K1, the crop and the download on every run of at least
``device_batch`` consecutive filled slots (of the slots the geometry's
buffer held at the call's start), and the rest of each bucket runs once
the entropy phase ends. A call's first frames of a geometry (no buffer
yet), frames past the buffer's capacity, a mesh (which takes multiples of
its size) and the CPU (where K1's twin would take the workers' cores)
keep that order: entropy first, then one launch a bucket. The results are
the same bytes either way.

Per-image isolation: an image that cannot be decoded becomes an error
record and never stops the corpus. A build, launch or CUDA failure (any
``RuntimeError``, ``NotImplementedError`` for a dtype with no CUDA kernel
among them) is not the image's fault and raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from jpeg_tpu_torch.entropy import device_huffman
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
from jpeg_tpu_torch.parallel.staging import Staging
from jpeg_tpu_torch.utils import profiling
from jpeg_tpu_torch.utils.profiling import span

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
    to the host route, ``staged_frames`` whose planes went straight into
    their staging slot (every K1 frame, except where a call holds more
    frames of a geometry than its buffer has slots), ``pinned_frames`` whose
    K1 input went up from page-locked staging, ``pinned_rgb_frames`` whose
    RGB came down into a page-locked result buffer (every K1 frame on the
    card, except while the caller still holds two earlier calls' results of
    the geometry), ``streamed_frames`` whose K1 launched before their
    call's entropy phase ended (see the module's docstring),
    ``entropy_launches`` (K3) and ``pixel_launches`` (K1 or K1a, one a
    data shard under a mesh) made through this decoder. ``routes`` holds,
    per item of the last :meth:`decode_all`, the route its entropy took:
    ``"host"``, ``"device"`` (K3) or ``"fallback"`` (claimed by the device
    thread, then decoded on the host).

    Under a ``torch.profiler`` session a call records its spans
    (:mod:`jpeg_tpu_torch.utils.profiling`); each frame's ``decode.parse``
    counts the DHT tables its parse read (``tables``) and those the
    process-wide table cache already held (``tables_reused``: every
    frame's tables are shared, read-only, with every other frame that
    carries the same DHT bytes; see ``io.container.parse_jpeg``).

    One :meth:`decode_all` at a time on a decoder: the staging slots and
    ``routes`` belong to the call in progress, and a second call made
    while one runs raises ``RuntimeError``. A call's results are views of
    a result buffer the decoder reuses only once nothing refers to them;
    they stay the caller's, unchanged, for as long as it holds them.
    :meth:`close` also frees the staging and result buffers.
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
        self.staged_frames = 0
        self.pinned_frames = 0
        self.pinned_rgb_frames = 0
        self.streamed_frames = 0
        self.entropy_launches = 0
        self.pixel_launches = 0
        self.routes: list[str] = []
        # Persistent pools: fresh threads per call would bring fresh native
        # scratch buffers and allocator arenas each time.
        self._pool = None
        self._dev_pool = None
        # K1's input and output; page-locked for the card K1 runs on.
        self._staging = Staging(mesh.first if mesh else self.device)
        self._busy = threading.Lock()

    def close(self) -> None:
        """Shut down the worker threads (idle between decode_all calls) and
        free the staging and result buffers."""
        for pool in (self._pool, self._dev_pool):
            if pool is not None:
                pool.shutdown(wait=True)
        self._pool = self._dev_pool = None
        self._staging.close()

    def _pools(self):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.workers)
            self._dev_pool = ThreadPoolExecutor(max_workers=1)
        return self._pool, self._dev_pool

    def _store(self, parsed, i, rec) -> None:
        """``parsed[i] = rec``; where the frame's planes lie in their
        staging slot, the slot is marked filled, under ``i``."""
        parsed[i] = rec
        if rec[5] is not None and rec[3] is None:
            self._staging.fill(rec[2], rec[5], i)

    def _entropy_one(self, item, route: str = "host"):
        """Host route -> (name, plan, geom, planes, error, slot). The
        planes go into staging slot ``slot``; planes is None then, or the
        frame's own copy where the buffer has no such slot yet. Plans K1
        does not take (another colour model, 12-bit, lossless) are decoded
        here through the compat path on ``self.device``: geom is then
        ``"compat"``, planes the image and slot None. ``route`` (``"host"``
        or ``"fallback"``) is counted on the ``decode.host_entropy``
        span."""
        try:
            with span("decode.parse"):
                plan = parse_jpeg(_read(item))
            if not fast_path_takes(plan):
                with span("decode.compat"):
                    rgb = decode_plan(plan, self.rounding, device=self.device)
                return (_name(item), plan, "compat", rgb, None, None)
            # The runtime hands back this thread's scratch buffers: copy
            # before the thread decodes another same-geometry image, or the
            # stored planes are overwritten (a flake the JAX package met in
            # its hybrid corpus test). Baseline Huffman decodes on this
            # thread alone; progressive and arithmetic decodes take the cpu
            # count's threads, as in the JAX package.
            with span("decode.host_entropy") as sp:
                planes = host_planes(plan, n_threads=1)
                geom = PipelineGeometry.of(plan)
                slot, views = self._staging.take(geom)
                if views is None:
                    planes = [p.copy() for p in planes]
                else:
                    for v, p in zip(views, planes):
                        np.copyto(v, p)
                    planes = None
                sp.add(route, 1)
            return (_name(item), plan, geom, planes, None, slot)
        except Exception as e:  # noqa: BLE001 — per-image isolation boundary
            return (_name(item), None, None, None, _error_text(e), None)

    @staticmethod
    def _device_eligible(plan) -> bool:
        """Plans K3 takes: 8-bit baseline Huffman YCbCr/gray with at least
        two restart segments that cover every MCU."""
        return (not plan.lossless and not plan.arith_code
                and not plan.progressive and plan.precision == 8
                and plan.color_model in ("ycbcr", "gray")
                and len(plan.segments) >= 2
                and sum(s.mcu_count for s in plan.segments) == plan.n_mcus)

    def _host_parse(self, items):
        """The host-only entropy phase, started: (parsed, its futures)."""
        pool, _ = self._pools()
        parsed: list = [None] * len(items)
        self.routes = ["host"] * len(items)
        frame = profiling.current()

        def one(i):
            with profiling.adopt(frame):
                self._store(parsed, i, self._entropy_one(items[i]))

        return parsed, [pool.submit(one, i) for i in range(len(items))]

    def _hybrid_parse(self, items):
        """The hybrid entropy phase, started: (parsed, its futures)."""
        parsed: list = [None] * len(items)
        routes = self.routes = ["host"] * len(items)
        work = deque(range(len(items)))
        lk = threading.Lock()
        k = self.device_batch
        frame = profiling.current()

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
            with profiling.adopt(frame):
                while (i := pop_front()) is not None:
                    self._store(parsed, i, self._entropy_one(items[i]))

        def to_host(idxs):
            with lk:
                self.fallback_frames += len(idxs)
            for i in idxs:
                routes[i] = "fallback"
                self._store(parsed, i, self._entropy_one(items[i], "fallback"))

        def finalize(pend):
            idxs, plans, coeffs, err = pend
            with span("decode.k3_wait") as sp:
                err = err.cpu().numpy()  # waits for this launch
                sp.add("frames", len(idxs))
            off = 0
            for i, p, c in zip(idxs, plans, coeffs):
                seg_err = bool(err[off : off + len(p.segments)].any())
                off += len(p.segments)
                if seg_err:
                    to_host([i])
                    continue
                geom = PipelineGeometry.of(p)
                with span("decode.relayout_d2h") as sp:
                    planes = coefficient_planes_from_blocks(c, geom)
                    if sp:
                        sp.add("bytes", sum(x.nbytes for x in planes))
                    slot, views = self._staging.take(geom)
                    if views is None:
                        planes = [x.cpu().numpy() for x in planes]
                    else:
                        for v, x in zip(views, planes):
                            torch.from_numpy(v).copy_(x)
                        planes = None
                routes[i] = "device"
                self._store(parsed, i,
                            (_name(items[i]), p, geom, planes, None, slot))
                with lk:
                    self.device_frames += 1

        def claim_plans(idxs):
            """Parse a claim; images the device does not take go to the host
            route. Returns (indices, plans) for the device."""
            keep, plans, host = [], [], []
            for i in idxs:
                try:
                    with span("decode.parse"):
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

        def device_side(first):
            on_cuda = self.device.type == "cuda"
            stream = torch.cuda.Stream(self.device) if on_cuda else None
            ctx = torch.cuda.stream(stream) if on_cuda else contextlib.nullcontext()
            pending = None
            claims = itertools.chain([first] if first else [],
                                     iter(pop_back_batch, None))
            with ctx, profiling.adopt(frame):
                for idxs in claims:
                    with span("decode.claim") as sp:
                        sp.add("frames", len(idxs))
                        idxs, plans = claim_plans(idxs)
                    if not plans:
                        continue
                    try:
                        with span("decode.k3_prepare") as sp:
                            batch = device_huffman.prepare_lane_batch(plans)
                            sp.add("frames", len(plans))
                            sp.add("bytes", batch.data.nbytes)
                    except device_huffman.BatchMismatch:  # before launch
                        to_host(idxs)
                        continue
                    with span("decode.k3_launch"):
                        coeffs, err = device_huffman.decode_prepared_batch(
                            batch, self.device)
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
        # The device thread's first claim is taken before any host worker
        # starts: a host route whose parse reuses its tables can drain a
        # small call before that thread is scheduled.
        dev_fut = dev_pool.submit(device_side, pop_back_batch())
        host_futs = [pool.submit(host_worker) for _ in range(self.workers)]
        return parsed, [*host_futs, dev_fut]

    def decode_all(self, items) -> list[DecodeResult]:
        """Decode a list of paths or byte strings; order preserved. Under
        ``torch.profiler`` the call is recorded as ``decode.call``
        (:mod:`jpeg_tpu_torch.utils.profiling`), its counts on that span."""
        if not self._busy.acquire(blocking=False):
            raise RuntimeError(
                "decode_all is already running on this decoder: one call at "
                "a time (its staging slots belong to the call in progress)")
        try:
            with profiling.call("decode.call") as root:
                if root:
                    before = (self.entropy_launches, self.pixel_launches,
                              self.staged_frames, self.pinned_frames,
                              self.pinned_rgb_frames, self.streamed_frames)
                results, parsed, buckets = self._decode_all(items)
                if root:
                    for route in ("host", "device", "fallback"):
                        root.add(f"{route}_frames", self.routes.count(route))
                    root.add("frames", len(items))
                    root.add("compat_frames",
                             sum(p[2] == "compat" for p in parsed))
                    root.add("error_frames",
                             sum(p[4] is not None for p in parsed))
                    root.add("buckets", len(buckets))
                    root.add("k3_launches", self.entropy_launches - before[0])
                    root.add("k1_launches", self.pixel_launches - before[1])
                    root.add("staged_frames", self.staged_frames - before[2])
                    root.add("pinned_frames", self.pinned_frames - before[3])
                    root.add("pinned_rgb_frames",
                             self.pinned_rgb_frames - before[4])
                    root.add("streamed_frames",
                             self.streamed_frames - before[5])
            return results
        finally:
            self._busy.release()

    def _decode_all(self, items):
        self._staging.begin()
        results: list = [None] * len(items)
        with span("decode.entropy"):
            parsed, futs = (self._hybrid_parse(items) if self.hybrid_device
                            else self._host_parse(items))
            streams = self._stream(parsed, futs, results)

        buckets: dict = {}
        for i, (name, plan, geom, planes, err, _) in enumerate(parsed):
            if err is not None:
                results[i] = DecodeResult(name, None, error=err)
            elif geom == "compat":  # decoded inline by its worker
                results[i] = DecodeResult(name, planes)
            else:
                buckets.setdefault(geom, []).append(i)
        for geom, idxs in buckets.items():
            idxs.sort(key=lambda i: parsed[i][5])  # slot order: 0..n-1
            # Frames whose slot the buffer lacked hold their own planes.
            unslotted = {parsed[i][5]: parsed[i][3] for i in idxs
                         if parsed[i][3] is not None}
            self.staged_frames += len(idxs) - len(unslotted)
            ran = sum(results[i] is not None for i in idxs)  # slots 0..ran-1
            out = streams.get(geom)
            if out is None or len(out[0]) < len(idxs):
                held, out = out, self._staging.results(geom, len(idxs))
                if ran:  # the call outgrew the array its runs came down to
                    out[0][:ran] = held[0][:ran]
                    for i in idxs[:ran]:
                        results[i] = DecodeResult(parsed[i][0],
                                                  out[0][parsed[i][5]])
            idxs = idxs[ran:]
            # A mesh takes a multiple of its size (the JAX package's rule);
            # the rest of the bucket is decoded unsharded.
            spill_from = (len(idxs) - len(idxs) % self.mesh.size
                          if self.mesh else len(idxs))
            for chunk, mesh in ((idxs[:spill_from], self.mesh),
                                (idxs[spill_from:], None)):
                if chunk:
                    with span("decode.pixel") as sp:
                        sp.add("frames", len(chunk))
                        self._pixel_stage(parsed, results, geom, chunk, mesh,
                                          unslotted, out)
        self._staging.end(buckets)
        return results, parsed, buckets

    def _streams(self) -> bool:
        """Whether the pixel stage streams behind the entropy phase: on a
        CUDA device without a mesh."""
        return self.mesh is None and self.device.type == "cuda"

    def _stream(self, parsed, futs, results) -> dict:
        """Wait for the entropy phase's futures. Where the decoder streams,
        meanwhile run the pixel stage on each run of filled staging slots
        that :meth:`Staging.wait_runs` hands out, into the geometry's result
        array (taken at its first run, one row a slot of its buffer).
        Returns those arrays by geometry."""
        streams: dict = {}
        try:
            if self._streams():
                for f in futs:
                    f.add_done_callback(self._staging.wake)

                def done():
                    return all(f.done() for f in futs)

                while runs := self._staging.wait_runs(self.device_batch,
                                                      done):
                    for geom, idxs in runs:
                        out = streams.get(geom)
                        if out is None:
                            out = streams[geom] = self._staging.results(
                                geom, self._staging.buffers[geom].capacity)
                        with span("decode.pixel") as sp:
                            sp.add("frames", len(idxs))
                            self._pixel_stage(parsed, results, geom, idxs,
                                              None, None, out)
                        self.streamed_frames += len(idxs)
        finally:
            wait(futs)
        for f in futs:
            f.result()
        return streams

    def _pixel_stage(self, parsed, results, geom, idxs, mesh, unslotted,
                     out) -> None:
        """K1 over one bucket's frames ``idxs`` (in slot order, a run of
        slots), on ``mesh`` or unsharded: the slots go up as K1's input, and
        the cropped RGB comes down into the same rows of the bucket's result
        array (``out``: the array and whether it is page-locked) before this
        returns. A run streamed during the entropy phase (``unslotted``
        None) reads the buffer as it stands; the rest of a bucket runs once
        every slot is filled, in the buffer grown to the call's frames."""
        with span("decode.stack") as sp:
            buf, copied = ((self._staging.buffers[geom], 0)
                           if unslotted is None
                           else self._staging.bucket(geom, unslotted))
            lo = parsed[idxs[0]][5]
            bp = [p[lo : lo + len(idxs)] for p in buf.planes]
            bq = np.stack([plan_quant_patterns(parsed[i][1], geom)
                           for i in idxs])
            if sp:
                sp.add("bytes", copied + bq.nbytes)
        with span("decode.k1"):
            if mesh is None and self.device.type == "cuda":
                # A DMA from pinned staging; the crop's download below, on
                # the same stream, waits for it before the slots are reused.
                bp = [torch.from_numpy(p).to(self.device, non_blocking=True)
                      for p in bp]
            planar = decode_batch_fast(bp, bq, geom, self.rounding,
                                       self.device, self.idct_mode, mesh=mesh)
            del bp  # K1's input on the card, free before the crop allocates
        self.pixel_launches += mesh.shape["data"] if mesh else 1
        if buf.pinned:
            self.pinned_frames += len(idxs)
        with span("decode.crop_d2h") as sp:
            array, pinned = out
            rgb = array[lo : lo + len(idxs)]
            # On the card PyTorch makes the crop contiguous there, then one
            # DMA into the rows, on the stream that made planar. The wait is
            # a blocking-sync event: the caller sleeps in it, where a stream
            # synchronise would spin a core the entropy workers need.
            torch.from_numpy(rgb).copy_(
                planar[:, :, : geom.height, : geom.width].permute(0, 2, 3, 1),
                non_blocking=True)
            if planar.is_cuda:
                landed = torch.cuda.Event(blocking=True)
                landed.record(torch.cuda.current_stream(planar.device))
                landed.synchronize()
            sp.add("bytes", rgb.nbytes)
            sp.add("pinned_bytes", rgb.nbytes if pinned else 0)
        if pinned:
            self.pinned_rgb_frames += len(idxs)
        for b, i in enumerate(idxs):
            results[i] = DecodeResult(parsed[i][0], rgb[b])
