"""Benchmark of the port: the counterpart of the repo-root ``bench.py``.

    python -m jpeg_tpu_torch.bench [--device cuda|cpu] [--repeats 5]
        [--frames 128] [--size 3840x2160] [--size-1080 1920x1080]
        [--idct-plane 4096x3840]

Diagnostics go to stderr. The last line of stdout is one JSON object with
``bench.py``'s structure: ``{"metric": "frames_per_s_per_chip_4k_decode",
"value": ..., "unit": "frames/s", "detail": {...}}``.

``value`` is the port's main path: ``BatchedCorpusDecoder(hybrid_device=
True).decode_all`` over ``--frames`` 4K frames (the two committed
restart-per-row fixtures, in turn), from bytes in host memory to RGB u8 in
host memory, every transfer included. It never falls back to another rung.

Every rung runs on ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain twins, for tests at small ``--size``). A rung that raises ends the
run: its name goes to stderr, the exception propagates, and no result line
is printed. Each rung is measured ``--repeats`` times: a rate key holds the
median and ``detail["spread"][key]`` ``[min, max]``; a frame count
(``*_device_frames``, ``e2e_corpus_fallback_frames``) is the sum over the
repeats. Kernel-rate rungs time queued launches with CUDA events after a
warm-up; whole-call and host rungs use the host clock, the card
synchronised before the clock stops. Each ``*_sol_fraction`` divides by
the NVIDIA H100 SXM's 3.35 TB/s, over ``bench.py``'s byte counts.

Key map (``bench.py`` key -> port route -> kernel):

- ``entropy_host_fps``, ``entropy_corpus_fps``,
  ``entropy_speculative_norestart_fps`` (``spec_chunks``: its chunk
  count, ``4 * cores``; ``spec_tuner`` ``{}`` and ``pgo`` ``"off"``, kept
  for ``bench.py``'s keys: the runtime has no tuner and one plain build),
  ``lossless_1080p_fps``, ``arithmetic_4k_entropy_fps``,
  ``arithmetic_4k_corpus_fps``, ``progressive_4k_entropy_fps``,
  ``progressive_4k_corpus_fps`` -> ``runtime`` (C++ on the host);
  ``encode_4k_fps``, ``encode_4k_corpus_fps`` -> ``encode_rgb`` (host);
  ``cpu_work_unit_mb_s``, ``host_cores`` -> the host;
- ``device_pipeline_fps``, ``idct_blocks_per_s``, ``device_sol_fraction``
  -> ``fused_plane_decode`` on one resident frame -> K1;
  ``device_pipeline_approx_fps`` -> the same, ``idct_mode="approx"`` -> K1a;
- ``idct_only_blocks_per_s``, ``idct_only_sol_fraction`` ->
  ``idct_only_kernel`` on an int16 ``--idct-plane`` -> K5;
- ``encode_4k_device_kernel_fps`` -> ``fused_plane_encode`` -> K2;
- ``corpus_1080p_entropy_fps`` (host workers), ``corpus_1080p_device_fps``
  (``fused_plane_decode`` on 8 frames) -> K1;
- ``device_entropy_window_4k_fps``, ``_batch``, ``_lanes`` ->
  ``window_runner_batch`` at ``DEVICE_BATCH`` frames -> K3;
  ``device_entropy_batched_fps``, ``_lanes`` -> the v1 and v2 batch names
  on 32 1080p frames -> K3;
- ``e2e_overlapped_fps`` (host workers + a K1 loop), ``e2e_hybrid_fps``,
  ``_device_frames``, ``_device_batch`` (host workers, a K3 batch thread
  and a K1 loop on resident inputs), ``corpus_1080p_hybrid_*`` (the same
  at 1080p, exact and approx) -> K1, K3, K1a;
- ``sharded_smoke`` (was ``sharded_mosaic_smoke``) ->
  ``decode_batch_fast(mesh=make_mesh())`` -> K1;
- ``h2d_mb_s`` (was ``tunnel_h2d_mb_s``) -> a pageable 4 MB copy;
- added: ``e2e_corpus_fps`` (= ``value``), ``e2e_corpus_device_frames``,
  ``e2e_corpus_fallback_frames`` (the decoder's counters), ``card``
  (``nvidia-smi`` name and power limit), ``torch``, ``cuda``, ``device``,
  ``repeats``, ``spread``.

Left out: ``libjpeg_1thread_fps``, ``libjpeg_allcore_fps``,
``vs_baseline`` and ``vs_libjpeg_allcore`` (the card's machine has no PIL,
so libjpeg cannot run there). :func:`bench_device_entropy_inkernel` (K4)
is ported and, as in ``bench.py``, not called by :func:`main`.

Inputs, at the default sizes: the 4K restart-per-row frames are the
committed ``tests/goldens/torch/synth_3840x2160_s{0,1}_q85_rst1.jpg`` (s0 is
byte for byte ``bench.py::make_4k_jpeg()``); the 4K pixels are
``synthetic_image(3840, 2160, 0)`` (the same formula; ``bench.py`` decodes
its JPEG with libjpeg); the frame without restarts is the port's
``encode_rgb`` of those pixels at q85, 4:2:0; the arithmetic frame
``encode_rgb(..., arithmetic=True, restart_interval_mcus=16)`` of them;
progressive 4K is the committed ``synth_3840x2160_s5_q85_rst0_prog.jpg``;
the 1080p frames are ``encode_rgb(synthetic_image(1920, 1080, i),
quality=85, restart_interval_mcus=120)``, a restart per MCU row; the
lossless frame is ``encode_lossless`` of seeded noise, predictor 4, a
restart per row. At another ``--size`` the restart-per-row and progressive
frames are the port's encodes of ``synthetic_image`` at that size.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from jpeg_tpu_torch import runtime
from jpeg_tpu_torch.entropy import (
    device_decode,
    device_decode2,
    device_huffman,
    device_kernel,
    device_window,
)
from jpeg_tpu_torch.entropy.lossless import encode_lossless
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.io.corpus import synthetic_image
from jpeg_tpu_torch.models.decoder import PipelineGeometry
from jpeg_tpu_torch.models.encoder import encode_rgb, encode_rgb_progressive
from jpeg_tpu_torch.ops import fused_encode, fused_plane, idct_only
from jpeg_tpu_torch.parallel.batch import decode_batch_fast
from jpeg_tpu_torch.parallel.mesh import make_mesh
from jpeg_tpu_torch.parallel.pipeline import DEVICE_BATCH, BatchedCorpusDecoder

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "goldens", "torch")
SIZE_4K = (3840, 2160)
FRAMES_4K = ("synth_3840x2160_s0_q85_rst1.jpg",
             "synth_3840x2160_s1_q85_rst1.jpg")
PROG_4K = "synth_3840x2160_s5_q85_rst0_prog.jpg"
QUALITY = 85
# The speed-of-light denominator: NVIDIA H100 SXM HBM3, data sheet.
H100_SXM_HBM_BYTES_PER_S = 3.35e12
# bench.py's run lengths: frames of the concurrent rungs, images of the
# 1080p rungs.
E2E_OVERLAPPED_FRAMES = 48
E2E_HYBRID_FRAMES = 384
HYBRID_1080P_FRAMES = 512
CORPUS_1080P_IMAGES = 8
BATCHED_1080P_IMAGES = 32
# The detail keys, bench.py's less the keys left out, through the renames,
# plus the port's own (module docstring).
KEYS = frozenset({
    "entropy_host_fps", "entropy_corpus_fps",
    "entropy_speculative_norestart_fps", "spec_chunks", "spec_tuner", "pgo",
    "lossless_1080p_fps", "arithmetic_4k_entropy_fps",
    "arithmetic_4k_corpus_fps", "progressive_4k_entropy_fps",
    "progressive_4k_corpus_fps", "encode_4k_fps", "encode_4k_corpus_fps",
    "cpu_work_unit_mb_s", "host_cores", "h2d_mb_s",
    "device_pipeline_fps", "idct_blocks_per_s", "device_sol_fraction",
    "idct_only_blocks_per_s", "idct_only_sol_fraction",
    "e2e_overlapped_fps", "e2e_hybrid_fps", "e2e_hybrid_device_frames",
    "e2e_hybrid_device_batch", "device_pipeline_approx_fps",
    "encode_4k_device_kernel_fps", "corpus_1080p_entropy_fps",
    "corpus_1080p_device_fps", "corpus_1080p_hybrid_fps",
    "corpus_1080p_hybrid_device_frames", "corpus_1080p_hybrid_device_batch",
    "corpus_1080p_hybrid_approx_fps", "sharded_smoke",
    "device_entropy_batched_fps", "device_entropy_batched_lanes",
    "device_entropy_window_4k_fps", "device_entropy_window_4k_batch",
    "device_entropy_window_4k_lanes",
    "e2e_corpus_fps", "e2e_corpus_device_frames",
    "e2e_corpus_fallback_frames", "card", "torch", "cuda", "device",
    "repeats", "spread",
})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# Clocks


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_s(fn, n: int = 1, dev: torch.device | None = None) -> float:
    """Seconds of ``n`` calls of ``fn`` on the host clock; with ``dev`` the
    card is synchronised before the clock starts and before it stops."""
    if dev is not None:
        sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if dev is not None:
        sync(dev)
    return time.perf_counter() - t0


def device_s(fn, n: int, dev: torch.device) -> float:
    """Seconds a call of ``fn`` over ``n`` calls in a row. On the card: CUDA
    events around the launches, the card first kept busy for ~20 ms so
    that every launch is queued before the start event is reached (the
    wrappers' host time stays out). On the CPU: the host clock."""
    if dev.type != "cuda":
        return host_s(fn, n) / n
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(40_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n


def corpus_rate(fn, iters: int) -> float:
    """Calls/s of ``fn(i)`` over ``iters`` calls on one worker thread per
    host core, after one untimed call per core (the workers' scratch
    buffers are allocated then)."""
    n = os.cpu_count() or 1
    with ThreadPoolExecutor(max_workers=n) as ex:
        list(ex.map(fn, range(n)))
        t0 = time.perf_counter()
        list(ex.map(fn, range(iters)))
        return iters / (time.perf_counter() - t0)


class Bench:
    """The rungs' results. ``rung`` runs one rung's setup, then measures it
    ``repeats`` times: rate keys hold the median, ``spread[key]`` ``[min,
    max]``; count keys are summed over the repeats."""

    def __init__(self, repeats: int):
        if repeats < 1:
            raise ValueError(f"repeats must be >= 1, got {repeats}")
        self.repeats = repeats
        self.detail: dict = {}
        self.spread: dict = {}

    def rung(self, name: str, setup, counts: tuple = ()) -> None:
        """``setup()`` -> (``measure``, constants); ``measure()`` -> a dict
        of rates and of the ``counts`` keys. A failure is logged with the
        rung's name and propagates."""
        t0 = time.perf_counter()
        try:
            measure, constants = setup()
            runs = [measure() for _ in range(self.repeats)]
        except BaseException:
            log(f"bench: rung {name} failed")
            raise
        for key in runs[0]:
            vals = [r[key] for r in runs]
            if key in counts:
                self.detail[key] = sum(vals)
            else:
                self.detail[key] = statistics.median(vals)
                self.spread[key] = [min(vals), max(vals)]
        self.detail.update(constants)
        shown = {k: self.detail[k] for k in (*runs[0], *constants)}
        log(f"{name}: {shown} ({time.perf_counter() - t0:.1f} s)")


# --------------------------------------------------------------------------
# Inputs


def _read(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def restart_frame(size: tuple[int, int], seed: int, fixture: str | None = None
                  ) -> bytes:
    """A q85 4:2:0 frame with a restart marker per MCU row: the committed
    fixture at 3840x2160, else the port's encode of ``synthetic_image``."""
    if fixture is not None and size == SIZE_4K:
        return _read(fixture)
    w, h = size
    return encode_rgb(synthetic_image(w, h, seed), quality=QUALITY,
                      restart_interval_mcus=-(-w // 16))


def norestart_stream(img: np.ndarray) -> bytes:
    """The speculative rung's frame: q85 4:2:0, no restart markers."""
    return encode_rgb(img, quality=QUALITY)


def arithmetic_stream(img: np.ndarray) -> bytes:
    """The arithmetic rung's frame (SOF9), a restart every 16 MCUs."""
    return encode_rgb(img, quality=QUALITY, arithmetic=True,
                      restart_interval_mcus=16)


def progressive_stream(size: tuple[int, int]) -> bytes:
    if size == SIZE_4K:
        return _read(PROG_4K)
    return encode_rgb_progressive(synthetic_image(*size, 5), quality=QUALITY)


def lossless_stream(size: tuple[int, int]) -> bytes:
    """SOF3 of seeded RGB noise, predictor 4, a restart per row."""
    w, h = size
    img = np.random.default_rng(3).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return encode_lossless(img, predictor=4, restart_interval=w)


@dataclasses.dataclass
class Inputs:
    frames_4k: list          # the two restart-per-row frames (seeds 0, 1)
    img_4k: np.ndarray       # seed 0's pixels
    norestart_4k: bytes
    arith_4k: bytes
    prog_4k: bytes
    frames_1080: list        # BATCHED_1080P_IMAGES restart-per-row frames
    lossless_1080: bytes


def make_inputs(size: tuple[int, int], size_1080: tuple[int, int]) -> Inputs:
    img = synthetic_image(*size, 0)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        frames_1080 = list(ex.map(lambda i: restart_frame(size_1080, i),
                                  range(BATCHED_1080P_IMAGES)))
    return Inputs(
        frames_4k=[restart_frame(size, s, f) for s, f in enumerate(FRAMES_4K)],
        img_4k=img, norestart_4k=norestart_stream(img),
        arith_4k=arithmetic_stream(img), prog_4k=progressive_stream(size),
        frames_1080=frames_1080, lossless_1080=lossless_stream(size_1080))


def decoded_planes(plan) -> list[np.ndarray]:
    """The C++ decoder's planes of ``plan``, copied out of thread scratch."""
    return [p.copy() for p in runtime.native_decode_planes(plan)]


def k1_launcher(plan, planes, dev, idct_mode: str = "exact", batch: int = 1):
    """(a call launching K1 / K1a on ``batch`` copies of one frame resident
    on ``dev``, the frame's geometry)."""
    geom = PipelineGeometry.of(plan)
    ps = [torch.from_numpy(np.repeat(p[None], batch, 0)).to(dev)
          for p in planes]
    qs = torch.from_numpy(np.repeat(
        fused_plane.plan_quant_patterns(plan, geom)[None], batch, 0)).to(dev)
    return (lambda: fused_plane.fused_plane_decode(ps, qs, geom, "truncate",
                                                   idct_mode)), geom


def plane_bytes(geom) -> int:
    """``bench.py``'s least traffic of one frame through K1: the int16
    planes read once, the padded planar u8 output written once."""
    shapes = fused_plane.padded_plane_shapes(geom)
    return sum(r * c * 2 for r, c in shapes) + 3 * shapes[0][0] * shapes[0][1]


# --------------------------------------------------------------------------
# Host rungs


def bench_cpu_work_unit():
    """SHA-256 over 64 MB on one thread, MB/s: a host yardstick that no code
    of this repository touches."""
    buf = bytes(16 << 20)
    hashlib.sha256(buf).digest()
    return (lambda: {"cpu_work_unit_mb_s": 64.0 / host_s(
        lambda: hashlib.sha256(buf).digest(), 4)}), {}


def bench_host_entropy(plan, iters: int = 10):
    """Frames/s of the threaded C++ plane decoder on one frame."""
    runtime.native_decode_planes(plan)
    return (lambda: {"entropy_host_fps": iters / host_s(
        lambda: runtime.native_decode_planes(plan), iters)}), {}


def bench_host_entropy_corpus(plan, iters: int = 24):
    """Corpus-mode entropy rate: one single-threaded decode per worker, a
    worker per core (per-thread reused plane buffers)."""
    def one(_):
        runtime.native_decode_planes(plan, n_threads=1)

    return (lambda: {"entropy_corpus_fps": corpus_rate(one, iters)}), {}


def bench_speculative(plan, iters: int = 8):
    """The threaded decode of a frame without restart markers: speculative,
    in ``4 * cores`` chunks."""
    runtime.native_decode_planes(plan)
    return (lambda: {"entropy_speculative_norestart_fps": iters / host_s(
        lambda: runtime.native_decode_planes(plan), iters)}), {}


def spec_tuner_detail(plan) -> dict:
    """``spec_chunks`` (the chunk count of ``plan``'s default threaded
    decode, ``4 * cores``, or None when it does not decode speculatively),
    ``spec_tuner`` and ``pgo`` (``{}`` and ``"off"``: no tuner, one plain
    build)."""
    cores = os.cpu_count() or 1
    return {"spec_chunks": (4 * cores if runtime.speculates(plan, cores)
                            else None),
            "spec_tuner": runtime.spec_tuner_snapshot(),
            "pgo": runtime.pgo_status()}


def bench_lossless(plan, iters: int = 6):
    runtime.native_decode_lossless(plan)
    return (lambda: {"lossless_1080p_fps": iters / host_s(
        lambda: runtime.native_decode_lossless(plan), iters)}), {}


def bench_arithmetic(plan, iters: int = 8, corpus_iters: int = 12):
    """SOF9 entropy: threaded over restart segments, and corpus mode."""
    runtime.native_decode_arith_planes(plan)

    def one(_):
        runtime.native_decode_arith_planes(plan, n_threads=1)

    def measure():
        return {"arithmetic_4k_entropy_fps": iters / host_s(
                    lambda: runtime.native_decode_arith_planes(plan), iters),
                "arithmetic_4k_corpus_fps": corpus_rate(one, corpus_iters)}
    return measure, {}


def bench_progressive(plan, iters: int = 4, corpus_iters: int = 12):
    """SOF2 entropy: chain-parallel C++, and corpus mode."""
    runtime.native_decode_progressive(plan, reuse_buffer=True)

    def one(_):
        runtime.native_decode_progressive(plan, reuse_buffer=True,
                                          n_threads=1)

    def measure():
        return {"progressive_4k_entropy_fps": iters / host_s(
                    lambda: runtime.native_decode_progressive(
                        plan, reuse_buffer=True), iters),
                "progressive_4k_corpus_fps": corpus_rate(one, corpus_iters)}
    return measure, {}


def bench_encode_4k(img, iters: int = 4):
    """Frames/s of ``encode_rgb`` (host NumPy transform + C++ pack), one
    frame at a time and in corpus mode (two frames per core)."""
    def one(_=None):
        encode_rgb(img, quality=QUALITY, restart_interval_mcus=16)

    one()
    n = os.cpu_count() or 1

    def measure():
        return {"encode_4k_fps": iters / host_s(one, iters),
                "encode_4k_corpus_fps": corpus_rate(one, 2 * n)}
    return measure, {}


# --------------------------------------------------------------------------
# Kernel rungs


def bench_h2d(dev, copies: int = 8):
    """MB/s of a pageable 4 MB host array copied to ``dev``."""
    src = torch.from_numpy(np.zeros(4 << 20, np.uint8))
    dst = torch.empty_like(src, device=dev)
    dst.copy_(src)
    sync(dev)
    return (lambda: {"h2d_mb_s": 4.0 * copies / host_s(
        lambda: dst.copy_(src), copies, dev)}), {}


def bench_device_pipeline(plan, planes, dev, iters: int = 32):
    """K1 on one resident frame: frames/s, blocks/s and the share of the
    H100 SXM's byte bound."""
    run, geom = k1_launcher(plan, planes, dev)
    run()
    sol_fps = H100_SXM_HBM_BYTES_PER_S / plane_bytes(geom)

    def measure():
        fps = 1.0 / device_s(run, iters, dev)
        return {"device_pipeline_fps": fps,
                "idct_blocks_per_s": fps * geom.total_blocks,
                "device_sol_fraction": fps / sol_fps}
    return measure, {}


def bench_device_pipeline_approx(plan, planes, dev, iters: int = 32):
    """K1a, the approx tier, on one resident frame."""
    run, _ = k1_launcher(plan, planes, dev, "approx")
    run()
    return (lambda: {"device_pipeline_approx_fps":
                     1.0 / device_s(run, iters, dev)}), {}


def bench_idct_roofline(dev, rows: int, cols: int, iters: int = 64):
    """K5 on a seeded int16 ``[rows, cols]`` plane: blocks/s and the share
    of the byte bound (2 bytes in, 4 out a coefficient)."""
    run = idct_only.idct_only_kernel(rows, cols)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-512, 512, (rows, cols))
                         .astype(np.int16)).to(dev)
    qp = torch.from_numpy(idct_only.quant_pattern(np.arange(1, 65), 128,
                                                  256)).to(dev)
    run(x, qp)
    sol_blocks = H100_SXM_HBM_BYTES_PER_S / (64 * 6)

    def measure():
        bps = rows * cols // 64 / device_s(lambda: run(x, qp), iters, dev)
        return {"idct_only_blocks_per_s": bps,
                "idct_only_sol_fraction": bps / sol_blocks}
    return measure, {}


def bench_encode_kernel(plan, dev, iters: int = 32):
    """K2 (colour, chroma box mean, forward DCT, quantise) on one resident
    seeded planar frame of ``plan``'s geometry."""
    geom = PipelineGeometry.of(plan)
    h, w = fused_plane.padded_size(geom)
    rng = np.random.default_rng(1)
    rgb = torch.from_numpy(rng.integers(0, 256, (1, 3, h, w), dtype=np.uint8)
                           ).to(dev)
    iq = torch.from_numpy(fused_encode.plan_inv_quant_tables(
        [plan.quant_tables[c.quant_id] for c in plan.components])[None]).to(dev)

    def run():
        fused_encode.fused_plane_encode(rgb, iq, geom)

    run()
    return (lambda: {"encode_4k_device_kernel_fps":
                     1.0 / device_s(run, iters, dev)}), {}


def bench_corpus_1080p(plans, dev, iters: int = 2, reps: int = 16):
    """The 1080p corpus's stages: host entropy with a worker per core over
    the images, and K1 on all of them in one launch."""
    def one(p):
        runtime.native_decode_planes(p, n_threads=1)

    run, _ = k1_launcher(plans[0], decoded_planes(plans[0]), dev,
                         batch=len(plans))
    run()
    n = len(plans)

    def measure():
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
            list(ex.map(one, plans))
            list(ex.map(one, plans))
            t0 = time.perf_counter()
            for _ in range(iters):
                list(ex.map(one, plans))
            entropy = n * iters / (time.perf_counter() - t0)
        return {"corpus_1080p_entropy_fps": entropy,
                "corpus_1080p_device_fps": n / device_s(run, reps, dev)}
    return measure, {}


def bench_device_entropy_window(plans, dev, iters: int = 3):
    """K3 through ``window_runner_batch`` on a batch of 4K frames."""
    run, args, (_max_mcus, n_lanes, _base, _bitend) = (
        device_window.window_runner_batch(plans, device=dev))
    run(*args)
    return (lambda: {"device_entropy_window_4k_fps":
                     len(plans) / device_s(lambda: run(*args), iters, dev)}), {
        "device_entropy_window_4k_batch": len(plans),
        "device_entropy_window_4k_lanes": n_lanes}


def bench_device_entropy_batched(plans, dev):
    """K3 under the v1 and v2 batch names on a 1080p corpus, lane
    preparation included: the faster name's frames/s."""
    names = (lambda: device_decode.decode_coefficients_device_batch(
                 plans, device=dev),
             lambda: device_decode2.decode_coefficients_device2_batch(
                 plans, device=dev))
    for fn in names:
        fn()
    sync(dev)
    return (lambda: {"device_entropy_batched_fps": max(
        len(plans) / host_s(fn, 1, dev) for fn in names)}), {
        "device_entropy_batched_lanes": sum(len(p.segments) for p in plans)}


def bench_device_entropy_inkernel(plan, dev, reps: int = 3):
    """K4 (the in-kernel v4 tier) on one frame, whole call on the host
    clock -> (frames/s, lanes, flagged lanes). Not called by :func:`main`,
    as in ``bench.py``."""
    run, args, _max_mcus, n_lanes = device_kernel.kernel_runner(plan, dev)
    _, err = run(*args)
    sync(dev)
    best = min(host_s(lambda: run(*args), 1, dev) for _ in range(reps))
    return 1.0 / best, n_lanes, int(err.sum())


# --------------------------------------------------------------------------
# Concurrent rungs (resident inputs, each device thread on its own stream)


def _own_stream(dev):
    return torch.cuda.Stream(dev) if dev.type == "cuda" else None


def _on(stream):
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(
        stream)


def _record(stream):
    """An event recorded on ``stream`` (None on the CPU, where the launch
    has finished when it returns)."""
    if stream is None:
        return None
    done = torch.cuda.Event()
    done.record(stream)
    return done


def _k1_loop(run, n: int, dev):
    """A thread body: ``n`` K1 launches on a stream of its own, waited for."""
    stream = _own_stream(dev)
    with _on(stream):
        for _ in range(n):
            run()
    if stream is not None:
        stream.synchronize()


def bench_e2e_overlapped(plan, planes, dev, n_frames: int = E2E_OVERLAPPED_FRAMES):
    """Host entropy workers (a worker per core) and a K1 loop over one
    resident frame decode ``n_frames`` each at once: frames / wall."""
    run, _ = k1_launcher(plan, planes, dev)
    run()
    n_workers = os.cpu_count() or 1

    def one(_):
        runtime.native_decode_planes(plan, n_threads=1)

    def measure():
        sync(dev)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_workers + 1) as ex:
            dev_fut = ex.submit(_k1_loop, run, n_frames, dev)
            list(ex.map(one, range(n_frames)))
            dev_fut.result()
        return {"e2e_overlapped_fps": n_frames / (time.perf_counter() - t0)}
    return measure, {}


def bench_e2e_hybrid(plan, planes, dev, n_frames: int = E2E_HYBRID_FRAMES,
                     idct_mode: str = "exact", prefix: str = "e2e_hybrid"):
    """Host workers (one per core) and a K3 batch thread claim disjoint
    frames from one counter while a K1 loop covers every frame, all on
    resident inputs. The device thread claims ``DEVICE_BATCH`` frames at a
    time (``bench.py`` sizes its claim to the TPU's VMEM; the card has
    none), keeps one launch in flight, and stops claiming while fewer than
    three batches beyond its claim are left (``bench.py``'s tail guard).
    Keys ``{prefix}_fps`` (``{prefix}_approx_fps`` with ``idct_mode=
    "approx"``: the rate alone), ``_device_frames``, ``_device_batch``."""
    k1_run, _ = k1_launcher(plan, planes, dev, idct_mode)
    k3_run, k3_args, _meta = device_window.window_runner_batch(
        [plan] * DEVICE_BATCH, device=dev)
    k1_run()
    k3_run(*k3_args)
    sync(dev)
    n_workers = os.cpu_count() or 1

    def measure():
        lock = threading.Lock()
        state = {"left": n_frames, "dev": 0}

        def claim(k, guard=0):
            with lock:
                if state["left"] >= k + guard:
                    state["left"] -= k
                    return True
                return False

        def host_worker():
            while claim(1):
                runtime.native_decode_planes(plan, n_threads=1)

        def retire(done):
            if done is not None:
                done.synchronize()
            with lock:
                state["dev"] += DEVICE_BATCH

        def dev_side():
            stream = _own_stream(dev)
            in_flight, prev = False, None
            with _on(stream):
                while claim(DEVICE_BATCH, guard=3 * DEVICE_BATCH):
                    k3_run(*k3_args)
                    done = _record(stream)
                    if in_flight:
                        retire(prev)
                    in_flight, prev = True, done
            if in_flight:
                retire(prev)

        sync(dev)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_workers + 2) as ex:
            futs = [ex.submit(_k1_loop, k1_run, n_frames, dev),
                    ex.submit(dev_side)]
            futs += [ex.submit(host_worker) for _ in range(n_workers)]
            for f in futs:
                f.result()
        fps = n_frames / (time.perf_counter() - t0)
        if idct_mode == "approx":
            return {f"{prefix}_approx_fps": fps}
        return {f"{prefix}_fps": fps, f"{prefix}_device_frames": state["dev"]}

    constants = ({} if idct_mode == "approx"
                 else {f"{prefix}_device_batch": DEVICE_BATCH})
    return measure, constants


def bench_sharded_smoke(plan, planes, dev):
    """``decode_batch_fast`` over ``make_mesh()`` (every visible card; on
    the CPU a mesh of ``dev``), one frame a shard, held to the unsharded
    call bit for bit."""
    mesh = make_mesh() if dev.type == "cuda" else make_mesh(devices=[dev])
    geom = PipelineGeometry.of(plan)
    n = mesh.size
    bp = [np.repeat(p[None], n, 0) for p in planes]
    bq = np.repeat(fused_plane.plan_quant_patterns(plan, geom)[None], n, 0)

    def measure():
        out = decode_batch_fast(bp, bq, geom, mesh=mesh)
        want = decode_batch_fast(bp, bq, geom, device=dev)
        if not torch.equal(out.to(dev), want):
            raise RuntimeError("decode_batch_fast over the mesh differs from "
                               "the unsharded call")
        return {}
    return measure, {"sharded_smoke": "ok"}


# --------------------------------------------------------------------------
# The headline: the main path over real bytes, transfers included


def bench_e2e_corpus(dec: BatchedCorpusDecoder, items: list, dev):
    """``dec.decode_all(items)``, bytes on the host to RGB u8 on the host,
    after one untimed pass: frames/s and the decoder's counts of frames
    decoded by K3 and sent back to the host route. Raises if an item fails
    to decode."""
    def decode():
        res = dec.decode_all(items)
        bad = [r.error for r in res if not r.ok]
        if bad:
            raise RuntimeError(f"{len(bad)} of {len(items)} frames failed: "
                               f"{bad[:3]}")

    decode()

    def measure():
        dev_frames, fallback = dec.device_frames, dec.fallback_frames
        wall = host_s(decode, 1, dev)
        return {"e2e_corpus_fps": len(items) / wall,
                "e2e_corpus_device_frames": dec.device_frames - dev_frames,
                "e2e_corpus_fallback_frames": dec.fallback_frames - fallback}
    return measure, {}


# --------------------------------------------------------------------------


def card_name(dev) -> str | None:
    """``nvidia-smi``'s name and power limit of the card (None on the CPU)."""
    if dev.type != "cuda":
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[dev.index or 0]


def build(dev) -> None:
    """Build (at first use) every library the rungs run, all at once."""
    loads = [runtime.load, runtime.load_encoder]
    if dev.type == "cuda":
        loads += [fused_plane.load_kernel, fused_encode.load_kernel,
                  device_huffman.load_kernel, idct_only.load_kernel]
    with ThreadPoolExecutor(len(loads)) as ex:
        for f in [ex.submit(load) for load in loads]:
            f.result()


def _size(text: str) -> tuple[int, int]:
    w, h = text.lower().split("x")
    return int(w), int(h)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m jpeg_tpu_torch.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain twins)")
    ap.add_argument("--repeats", type=int, default=5,
                    help="measurements a rung (median and [min, max] kept)")
    ap.add_argument("--frames", type=int, default=128,
                    help="4K frames of the headline corpus decode")
    ap.add_argument("--size", type=_size, default=SIZE_4K,
                    help="the 4K frame's WxH (default 3840x2160)")
    ap.add_argument("--size-1080", type=_size, default=(1920, 1080),
                    help="the 1080p frame's WxH (default 1920x1080)")
    ap.add_argument("--idct-plane", type=_size, default=(4096, 3840),
                    help="K5's int16 plane as ROWSxCOLS (default 4096x3840)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run every rung, print the result line, and return it."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("jpeg_tpu_torch.bench: no CUDA device "
                         "(torch.cuda.is_available() is False); "
                         "pass --device cpu for the plain twins")
    t_start = time.perf_counter()
    card = card_name(dev)
    log(f"device {dev}, card {card}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {os.cpu_count()} host cores")
    build(dev)
    inp = make_inputs(args.size, args.size_1080)
    plan = parse_jpeg(inp.frames_4k[0])
    planes = decoded_planes(plan)
    plans_1080 = [parse_jpeg(d) for d in inp.frames_1080]
    log(f"inputs: 4K plan {plan.width}x{plan.height}, {len(plan.segments)} "
        f"segments, {plan.total_blocks} blocks ({time.perf_counter() - t_start:.1f} s)")

    b = Bench(args.repeats)
    # Host rungs, bench.py's order.
    b.rung("cpu_work_unit", bench_cpu_work_unit)
    b.rung("host_entropy", lambda: bench_host_entropy(plan))
    b.rung("host_entropy_corpus", lambda: bench_host_entropy_corpus(plan))
    plan_nr = parse_jpeg(inp.norestart_4k)
    b.rung("speculative_norestart", lambda: bench_speculative(plan_nr))
    b.detail.update(spec_tuner_detail(plan_nr))
    log(f"speculative: chunks {b.detail['spec_chunks']}")
    b.rung("lossless", lambda: bench_lossless(parse_jpeg(inp.lossless_1080)))
    b.rung("arithmetic", lambda: bench_arithmetic(parse_jpeg(inp.arith_4k)))
    b.rung("progressive", lambda: bench_progressive(parse_jpeg(inp.prog_4k)))
    b.rung("encode_4k", lambda: bench_encode_4k(inp.img_4k))
    # Kernel and concurrent rungs, bench.py's device stage order.
    b.rung("h2d", lambda: bench_h2d(dev))
    b.rung("device_pipeline", lambda: bench_device_pipeline(plan, planes, dev))
    b.rung("idct_roofline", lambda: bench_idct_roofline(dev, *args.idct_plane))
    b.rung("e2e_overlapped", lambda: bench_e2e_overlapped(plan, planes, dev))
    b.rung("e2e_hybrid", lambda: bench_e2e_hybrid(plan, planes, dev),
           counts=("e2e_hybrid_device_frames",))
    b.rung("device_pipeline_approx",
           lambda: bench_device_pipeline_approx(plan, planes, dev))
    b.rung("encode_kernel", lambda: bench_encode_kernel(plan, dev))
    b.rung("corpus_1080p", lambda: bench_corpus_1080p(
        plans_1080[:CORPUS_1080P_IMAGES], dev))
    p1080 = plans_1080[0]
    pl1080 = decoded_planes(p1080)
    b.rung("corpus_1080p_hybrid", lambda: bench_e2e_hybrid(
        p1080, pl1080, dev, HYBRID_1080P_FRAMES, prefix="corpus_1080p_hybrid"),
        counts=("corpus_1080p_hybrid_device_frames",))
    b.rung("corpus_1080p_hybrid_approx", lambda: bench_e2e_hybrid(
        p1080, pl1080, dev, HYBRID_1080P_FRAMES, idct_mode="approx",
        prefix="corpus_1080p_hybrid"))
    b.rung("sharded_smoke", lambda: bench_sharded_smoke(plan, planes, dev))
    b.rung("device_entropy_batched",
           lambda: bench_device_entropy_batched(plans_1080, dev))
    b.rung("device_entropy_window", lambda: bench_device_entropy_window(
        [parse_jpeg(inp.frames_4k[i % 2]) for i in range(DEVICE_BATCH)], dev))
    del planes, pl1080
    # The headline.
    items = [inp.frames_4k[i % 2] for i in range(args.frames)]
    dec = BatchedCorpusDecoder(hybrid_device=True, device=dev)
    try:
        b.rung("e2e_corpus", lambda: bench_e2e_corpus(dec, items, dev),
               counts=("e2e_corpus_device_frames",
                       "e2e_corpus_fallback_frames"))
    finally:
        dec.close()

    detail = dict(sorted(b.detail.items()))
    detail.update({
        "host_cores": os.cpu_count(), "card": card,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "repeats": args.repeats, "spread": b.spread})
    result = {"metric": "frames_per_s_per_chip_4k_decode",
              "value": detail["e2e_corpus_fps"], "unit": "frames/s",
              "detail": detail}
    log(f"bench: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
