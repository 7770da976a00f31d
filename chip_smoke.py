#!/usr/bin/env python3
"""Smoke run of jpeg_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the C++ entropy runtime and entropy encoder (the port's own copies
of the JAX package's C++ sources, ``jpeg_tpu_torch/runtime/native/``), the
seven CUDA libraries (K1-K8, K1a with K1), the K3 pass-1 ablation's library,
two K1 cell variants and the host tools' programs (two AddressSanitizer
builds of the C++ sources, the four microbenchmarks, the libjpeg harness
where ``jpeglib.h`` is found) from this checkout (all at once), checks
each kernel against its plain PyTorch version at the shapes its path gives
it (K1, its approx tier K1a and K2 on every sampling they
take, K3 and K4 on corrupt streams and eight 4K frames, K7 on a 4K frame
without restart markers and at 512x384; K1a, whose IDCT
runs on the tensor cores, to the tolerance of their order of sums, the
others bit for bit), shows that K1a's machine code holds tensor-core
instructions (HMMA) and K1's none, holds K1a within the approx gate of K1
(docs/APPROX_QUALITY.md), times K1 and K1a at 8 and 62 4K frames, K3 at 1,
8 and 32, K4 and K2 at 1 and 8, each beside its bound, holds K8 (the
encoder's Huffman pack, ``csrc/huffman_encode.cu``) to the C++ packer's
bytes on K2's planes and times it at 4K, then drives these paths:

- the hybrid host + device corpus decode of 64 images (62 of them
  3840x2160 frames) through ``BatchedCorpusDecoder(hybrid_device=True)``
  (K3 and K1);
- encode -> decode: eight 3840x2160 frames encoded by
  ``encode_rgb_device`` (K2 and K8), held to the CPU route's
  bytes and to the host encoder's pixels, then decoded as a 32-item corpus
  through the hybrid decoder (K3 and K1) and held to the host route and to
  the source images;
- the single-frame device-entropy decode of one 3840x2160 frame:
  ``decode_coefficients_device4`` (K4, held to its plain version on that
  frame), ``coefficient_planes_from_blocks`` and K1, the coefficients
  staying on the card, held to ``decode_bytes(path="fast")``; K4's batch
  tier is held to K3 and the C++ decoder on eight frames;
- every stream kind beside baseline Huffman YCbCr / gray (below);
- the bare dequant + IDCT of ``bench.py``'s roofline shape, a [4096, 3840]
  int16 plane, through ``idct_only_kernel`` (K5) and
  ``idct_only_kernel_roll`` (K6), each held to its plain version bit for
  bit and to a float64 reference, timed queued and after an L2 flush.

Between the last two, ``decode_bytes``' default route (the compat decode,
no kernel of its own) decodes a 4K frame and two 512x384 images on the card
and is held within +-1 u8 of the fast path and of the CPU. Then every other
8-bit DCT stream kind: a 3840x2160 libjpeg progressive frame and a SOF9
frame with a restart per MCU row go through K1 bit for bit with the CPU
route (host entropy and H2D + K1 + D2H timed apart), SOF10, progressive
gray, CMYK (baseline and progressive), YCCK and RGB-direct 512x384 images
through their routes; a mixed corpus of these with eight baseline 4K
frames runs through ``BatchedCorpusDecoder(hybrid_device=True)`` (K3 and
K1; the progressive and SOF9 frames share the baseline frames' K1 bucket)
and through ``CorpusDecoder`` on both paths, each item held to its route's
``decode_bytes`` on the card.

The ``speculative`` phase drives the speculative chunk-lane decode
(``entropy/device_spec.py``: K7's phase A on the card, the host merge with
C++ gap recovery, the relocate on the card) on a 3840x2160 q85 4:2:0 frame
without restart markers, encoded by the port: at 2,048 and 1,024 lanes and
with an overlap of 2 MCUs (gap recovery), each bit for bit with the C++
decoder, and on the restart-per-row 4K fixture (several segments merged);
K7 equals its plain twin at 512x384 and at 4K; the phase times K7, the
control arrays' copy, the merge, the relocate and the whole call beside the
C++ speculative decode and K3 on the same frame, K7's byte bound, and its
longest lane's symbols (the serial depth) with an estimate, not a bound, of
their time.

The ``scale_out`` phase, right after the main path, drives the sharded
routes of ``jpeg_tpu_torch/parallel/`` (``mesh.py``, ``batch.py``, the
corpus decoder's ``mesh=``, ``dryrun.py``), each held bit for bit to its
unsharded route, with the kernels it launches counted:
``decode_batch_fast(mesh=make_mesh())`` (the visible cards) and over a
(2, 2) grid that names this card four times, on the eight 3840x2160 frames
(K1 once a data shard); ``decode_batch_rows_sp_fast`` on that grid over
four 3840x2048 frames encoded by the port (K1 once a band, at the band's
geometry), and its refusal of the 3840x2160 geometry (135 MCU rows hold no
whole K1 bands per shard), as JAX refuses it; ``decode_batch_rows_sp`` on
a (2, 3) grid and ``decode_batch_with_metrics`` (counts exact) over two
3840x2160 frames; ``encode_batch_device(mesh=)`` on the eight 4K frames
(K2 once a data shard); ``BatchedCorpusDecoder(mesh=, hybrid_device=True)``
on the main path's 64 items (K3 and K1), equal to the unsharded hybrid
route and the C++ host route; and ``dryrun_multichip(8)`` on the card. It
times the mesh routes against the unsharded K1 call, with the card's name
and power limit beside them: what a mesh costs on one card, not a scaling
figure.

Two phases cover the rest of the format matrix. ``entropy_names`` runs
the main path's claim (eight 4K frames, 1,080 lanes) through K3 under every
device-entropy tier name of the JAX package (v1, v2, v3, the v2 batch and
``window_runner_batch``), each launching K3 once and equal bit for bit to
``decode_coefficients_device5_batch``, whose frames equal the C++ decoder's.
``formats`` decodes 12-bit streams (4K SOF1 4:2:0, SOF9 and SOF2; SOF10 at
512x384) through the compat route on the card (``decode_bytes``,
``decode_file``, ``decode_batch``, the corpus decoders' inline route), u16
within +-1 of the CPU run; reconstructs lossless 4K RGB differences with
``torch.cumsum`` on the card (equal to the image and the CPU run) and decodes
512x384 lossless streams end to end (equal to the CPU run,
``native_decode_lossless``, ``reconstruct`` and the source, the frames
counted by route); and runs the encoders that write these streams (host, as
in the JAX package): each stream decodes back to its encoder's quantized
coefficients, their C++ and Python routes write the same bytes, and the
4K encodes, the 4K 12-bit decode (entropy and dense stage apart) and the
4K ``reconstruct_device`` are timed on the host clock.

Last, the command line (``cli_path``): ``jpeg_tpu_torch.cli.main`` in
process on the main path's 64 items written to a temporary directory:
``corpus --batched --hybrid-device`` with a manifest (K3 and K1), the same
resumed in runs of ``--limit 24``, ``corpus --idct approx`` (K1a) with the
approx gate and K1a's twin checked in process, ``decode`` (fast exact and
approx, compat,
``--engine oracle``), ``encode`` of a P6, ``info`` (also as ``python -m
jpeg_tpu_torch``) and one K1 launch inside ``device_trace``.

Then the port's two evidence tools (``jpeg_tpu_torch/tools/``).
``approx_quality_phase`` runs ``measure_approx_quality.main``: its six
synthetic cases (4K q70 / q85 / q95, 1080p q85, gray 1080p q90, 4:4:4
1080p q92) through K1 and K1a, the worst case inside the approx gate.
``endurance_phase`` writes the main path's 62 4K frames to a temporary
directory and runs ``endurance.main`` on them: the command line's ``corpus
--batched --hybrid-device --manifest`` in child processes, a short pass of
16, the whole corpus killed at 16 images done and resumed in ``--limit
24`` segments (``--chunk-size 8``), with RSS and the card's memory
sampled, and a CPU control of 12 images in chunks of 4; its record is
printed on a line of its own. Every fault it reports raises, and its exit
code must follow its gate. Neither half of the gate is held here, only
printed: at this size two processes differ by more than the gate's 10%
in frames/s with no decay, and the control's RSS moves by up to ~380 MB
between chunks of 4 (up to ~95 MB an image against the gate's 2.0)
without a leak.

Then the port's kernel-study tools (``tools_phase``): the corrupt-stream
fuzz (``jpeg_tpu_torch/tools/fuzz.py``) over seeds 0-2 of its 20 variants,
each case through both engines on the card, K1's fast path against the
CPU, K3 and K4 against their twins and the C++ decoder, K7 against the C++
decoder, and the hybrid corpus decoder with the case in a claim of 4K
frames, no problem and every kernel reached by a case; the same seeds'
device routes in a child under ``compute-sanitizer --tool memcheck`` (0
errors), where the toolkit has it (where it refuses the card, as
compute-sanitizer 2025.2.1 refuses an NVIDIA H100 80GB HBM3, its refusal
is printed); the two-sentinel check of K3, K4 and K7 on the damaged
cases of seeds 0-2 (``jpeg_tpu_torch/tools/sentinel.py``: their
``torch.empty`` outputs pre-filled with two different bytes, every entry
a consumer reads equal); two rungs of K7's ladder
(``bench_device_spec.run``, which also times the ``speculative`` phase's
whole calls) on both of its 4K frames; K3's pass-1 ablation, variants (a)
and (b), on the 2,025-lane stream, (a) equal to the shipping pass 1's
records; and two K1 cells of the sweep at 8 4K frames, K1 and K1a bit for
bit with the shipping cell.

Then the host C++ runtime and its tools (``host_runtime_phase``; host
numbers, printed with the host's CPU model and the card): the speculative
planes of a 4K frame without restarts at ``{4, 6, 8} x threads`` chunks
bit for bit with the sequential decode; ``abench`` in all five modes; the
four C++ microbenchmarks on the dumped 4K streams; libjpeg's coefficients
of the port's 4K SOF9 frame against the port's where ``jpeglib.h`` is found
(its absence printed); and the AddressSanitizer sweep of the runtime and
encoder over fuzz seeds 0-2, failing on any report.

Then the port's bench (``bench_phase``): ``jpeg_tpu_torch.bench.main``
with 32 headline frames and one repeat, its JSON line printed among these
lines; its keys, rates, fallback count, card and kernel launches (K1, K1a,
K2, K3, K5) are checked, and ``spec_chunks`` is ``4 x cores`` and ``pgo``
``off``.

Each path runs with the launch counters set to 0 just before it and read
just after. The script exits non-zero at the first failed check, without a
result line, and when no CUDA device is present.

A kernel's bound is the least time the card could take for its work: the
larger of its bytes (inputs read once, outputs written once) over the
H100 SXM's 3.35 TB/s and its operations at the rate of their type: fp32
over 67 TFLOP/s, K1a's bf16 tensor-core products over 989 TFLOP/s (K3, K4
and K7 do integer work, for which the data sheet gives no rate: bytes only).
``library_ms`` is one PyTorch route to the same function where there is
one (K5 and K6: cuDNN convolution + pixel shuffle), timed and never used.

Output: check lines, then the ``nvidia-smi`` name and power limit, one JSON
line describing the kernels, and last a JSON result line.

    python3 chip_smoke.py --times [--package DIR]

only builds the kernels and times them at those shapes (K1 and K1a at 8
and 62 4K frames, K2-K6 as above; no checks, no result line), from this
checkout's package or
from the ``jpeg_tpu_torch`` of another checkout ``DIR``: two versions of a
kernel are compared by running both on the same card, one after the other,
in turns.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "goldens", "torch")
FRAMES_4K = ["synth_3840x2160_s0_q85_rst1.jpg", "synth_3840x2160_s1_q85_rst1.jpg"]
SMALL_RST = ["synth_512x384_s2_q85_rst1.jpg", "synth_512x384_s4_q85_rst1_gray.jpg"]
SMALL_NO_RST = "synth_512x384_s3_q85_rst0.jpg"
PROG_4K = "synth_3840x2160_s5_q85_rst0_prog.jpg"   # libjpeg, no restarts
SOF9_4K = "synth_3840x2160_s6_q85_rst1_sof9.jpg"   # a restart per MCU row
K1_ROUTE_SMALL = ["synth_512x384_s7_q85_rst0_sof10.jpg",
                  "synth_512x384_s12_q85_rst0_gray_prog.jpg"]
COMPAT_ROUTE = ["synth_512x384_s8_q85_rst0_cmyk.jpg",
                "synth_512x384_s9_q85_rst0_cmyk_prog.jpg",
                "synth_512x384_s10_q85_rst0_ycck.jpg",
                "synth_512x384_s11_q85_rst0_rgb.jpg"]
MIXED_COPIES = 4  # copies of each 4K progressive and SOF9 frame in the corpus
MIXED_BATCH = 4   # frames per device claim in the mixed corpus
BATCH = 8        # frames per K1 / K2 / K3 check, and per device claim
CORPUS_4K = 62   # 4K frames in the decode corpus (plus two small images)
ROUND_TRIP = 32  # items in the encode -> decode corpus (the 8 streams, repeated)
QUALITY = 85
FORMATS_4K = (3840, 2160)     # the formats phase's frames (width, height)
FORMATS_SMALL = (512, 384)    # its Python-coded and end-to-end lossless ones
RESTART_4K = 240  # MCUs per restart interval: one per MCU row of a 4K frame
# The bench phase's headline corpus: enough 4K frames that the device thread
# claims a batch (it leaves the host workers three batches).
BENCH_FRAMES = 32
# The scale-out phase's band frames: 4K wide, 128 MCU rows (whole K1 bands
# per seg shard; 2160 rows, 135 MCU rows, split into none).
BAND_FRAME = (3840, 2048)
K3_FRAMES = (1, 8, 32)  # 4K frames per timed K3 launch (135 lanes each)
K3_INPUTS = ("data", "lane_start", "lane_len", "lane_nblk", "lane_out",
             "skip", "pair", "skip_hv", "skip_canon", "skip_slots")
K7_INPUTS = ("data", "bit_start", "chunk_end_bit", "seg_end_bit", "skip",
             "skip_hv", "skip_canon", "skip_slots")
# An estimate, not a bound, of K7's serial time: its longest lane's symbols
# one after another at ~370 cycles a step (K3's pass 1 on its longest lane,
# jpeg_tpu_torch/tools/ablate_kernel.py's full variant on the H100, PERF.md
# section 6; not a floor of the card), at the SM's 1,980 MHz boost clock
# (H100 SXM data sheet).
K3_CYCLES_PER_STEP_EST = 370
SM_CLOCK_HZ = 1.98e9
# K1 buckets beyond the main path's: luma (h, v) over 1x1 chroma, and gray.
K1_SAMPLINGS = {"1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2),
                "4x1": (4, 1), "4x4": (4, 4), "gray": None}
IDCT_SHAPE = (4096, 3840)  # bench.py's bench_idct_roofline plane
IDCT_REL_TOL = 1e-6        # K5/K6 vs float64, relative to max |out|
HBM_BYTES_PER_S = 3.35e12  # H100 SXM spec peaks (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12  # dense bf16 tensor-core rate
# fp32 operations of the transform kernels: a 1-D pass is 8 products and 7
# sums per output, two passes per 8x8 block, plus one dequantise (K5, K6)
# or quantise (K2) product per coefficient; K1 forms each mirrored product
# once (4 of the 8 a pass per output pair); colour per output pixel: K1 12
# (+3 when rounding), K2 15 (its chroma box mean not counted).
OPS_PER_BLOCK = 2 * 64 * 15 + 64
K1_OPS_PER_BLOCK = 2 * (32 * 8 + 64 * 7) + 64
# K1a: per pair of blocks one m16n8k16 and one m16n8k8 bf16 product (2 x
# 16 x 8 x 16 + 2 x 16 x 8 x 8 operations), per block 64 fp32 dequantise
# products; colour as K1.
K1A_TC_OPS_PER_BLOCK = (2 * 16 * 8 * 16 + 2 * 16 * 8 * 8) // 2
# docs/APPROX_QUALITY.md's gate for the approx tier against the exact one.
APPROX_MAX_DIFF = 2
APPROX_MIN_PSNR = 50.0
# K1a against its plain twin: the tensor cores sum the exact bf16 products
# in their own order, a few fp32 ulps from the twin's, which rarely moves a
# value across a bf16 rounding point of the vertical pass or a u8 boundary:
# max |diff| <= 2 u8, at most 1e-3 of the values differing, every frame
# >= 70 dB (a wrong basis, rounding or pair packing changes percents).
K1A_TWIN_MAX_DIFF = 2
K1A_TWIN_MAX_SHARE = 1e-3
K1A_TWIN_MIN_PSNR = 70.0

# The tools phase: fuzz seeds [0, 3) over every route (and again under
# compute-sanitizer's memcheck, clean corpus frames at 256x128, no twins:
# those seeds were held to them just before), the two-sentinel check on
# seeds [0, 3), two rungs of K7's ladder, the pass-1 ablation's (a) and (b)
# on the 2,025-lane stream, two K1 cells at 8 frames. The sanitizer's own
# line when it refuses the card (as compute-sanitizer 2025.2.1 refuses an
# NVIDIA H100 80GB HBM3): printed, not passed.
FUZZ_SEEDS = (0, 3)
SENTINEL_SEEDS = (0, 3)
SANITIZER_CLEAN = "256x128"
SANITIZER_TIMEOUT_S = 420
LADDER_CONFIGS = ((512, 8), (2048, 4))
REFUSED_BY_SANITIZER = ("========= Error: Device not supported. Please refer "
                        "to the \"Supported Devices\" section of the "
                        "sanitizer documentation")
SWEEP_SHAPES = ((128, 128), (256, 256))
# The host_runtime phase: the microbenchmarks' repetitions and QM
# decisions, the ASan sweep's fuzz seeds (inclusive).
MICRO_REPS = 3
MICRO_DECISIONS = 4_000_000
ASAN_SEEDS = (0, 2)


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    print(f"ok: {what}", flush=True)


def read(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def synthetic_image(width: int, height: int, seed: int) -> np.ndarray:
    """The image tests/gen_torch_fixtures.py encoded (same formula as
    jpeg_tpu.io.corpus.synthetic_image, which this script may not import)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    img = np.stack([
        128 + 80 * np.sin(xx / 97.0 + seed) * np.cos(yy / 71.0),
        128 + 80 * np.sin(xx / 53.0 + 1.0) * np.cos(yy / 113.0 + seed),
        128 + 80 * np.sin(xx / 151.0 + 2.0) * np.cos(yy / 41.0),
    ], axis=-1)
    img += rng.normal(0, 6.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0**2 / mse)


def cuda_ms(fn, reps: int, warmup: int = 1, inner: int = 1,
            queued: bool = False) -> float:
    """Median milliseconds of ``fn()`` on the current stream, CUDA events
    around ``inner`` calls in a row (so short kernels queue up behind each
    other and the host's launch overhead hides). ``queued`` first keeps the
    card busy for ~20 ms, so that every call is enqueued before the first
    event is reached and the wrapper's host time is not in the result."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda.synchronize()
            torch.cuda._sleep(40_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def cuda_ms_flushed(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of one ``fn()`` after a 256 MB write that leaves
    none of its inputs in the 50 MB L2 cache; the write and ~20 ms of
    sleep (so that the call is enqueued before its start event is reached)
    lie outside the event pair."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        flush.zero_()
        torch.cuda._sleep(40_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def same_bits(a, b) -> bool:
    """Equal float32 tensors bit for bit (the sign of a zero included)."""
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ops_ms(n_ops: float = 0.0, n_tc_ops: float = 0.0) -> float:
    """The least time for ``n_ops`` fp32 operations and ``n_tc_ops`` bf16
    tensor-core operations, each at its peak rate."""
    return (n_ops / FP32_OPS_PER_S + n_tc_ops / BF16_TC_OPS_PER_S) * 1e3


def bound(n_bytes: int, n_ops: float = 0.0, n_tc_ops: float = 0.0) -> dict:
    """The least time for ``n_bytes`` moved and ``n_ops`` fp32 (and
    ``n_tc_ops`` bf16 tensor-core) operations, and which of the two sets
    it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(n_ops, n_tc_ops)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def share(ms: float, b: dict) -> str:
    return (f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
            f"{b['bound_ms'] / ms:.4f} of it")


class TwinStats:
    """K1a against its plain twin, accumulated over every comparison: the
    largest |diff|, values differing, values compared, smallest frame PSNR."""

    def __init__(self):
        self.max, self.differ, self.values, self.min_psnr = 0, 0, 0, float("inf")

    def check(self, got, want, what: str) -> None:
        """Hold u8 frames ``got`` to ``want`` (tensors or arrays, first axis
        the frame) within the tolerance, and add them to the totals."""
        import torch

        d = (torch.as_tensor(got).to(torch.int16)
             - torch.as_tensor(want).to(torch.int16)).abs()
        mx, n = int(d.max()), int((d != 0).sum())
        # The smallest frame PSNR is the largest frame MSE's.
        mse = (d.double() ** 2).flatten(1).mean(1).max().item() if n else 0.0
        p = float("inf") if mse == 0 else 10.0 * np.log10(255.0**2 / mse)
        self.max, self.min_psnr = max(self.max, mx), min(self.min_psnr, p)
        self.differ += n
        self.values += d.numel()
        check(mx <= K1A_TWIN_MAX_DIFF and n <= K1A_TWIN_MAX_SHARE * d.numel()
              and p >= K1A_TWIN_MIN_PSNR,
              f"K1a vs plain, {what}: max |diff| {mx} <= {K1A_TWIN_MAX_DIFF} "
              f"u8, {n / d.numel():.3e} of values differ <= "
              f"{K1A_TWIN_MAX_SHARE}, smallest PSNR {p:.2f} dB >= "
              f"{K1A_TWIN_MIN_PSNR}")


def sass_ops(lib_path: str, op: str) -> dict:
    """How many ``op`` instructions each function of a built library holds
    (``cuobjdump -sass``, beside nvcc), by mangled name."""
    from jpeg_tpu_torch.utils.build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "*/" in line and f" {op}" in line.split("*/")[1]:
            counts[fn] += 1
    return counts


def k1_inputs(plans, dev):
    """K1's inputs for a batch of equal-geometry plans: (int16 planes per
    component [B, rows, stride] and tables [B, n_comp, 64] on ``dev``, the
    geometry, the C++ decoder's planes per image)."""
    import torch

    from jpeg_tpu_torch import runtime
    from jpeg_tpu_torch.models.decoder import PipelineGeometry
    from jpeg_tpu_torch.ops import fused_plane as k1

    geom = PipelineGeometry.of(plans[0])
    hp = [[p.copy() for p in runtime.native_decode_planes(pl)] for pl in plans]
    planes = [torch.from_numpy(np.stack([h[c] for h in hp])).to(dev)
              for c in range(len(hp[0]))]
    qtabs = torch.from_numpy(np.stack(
        [k1.plan_quant_patterns(pl, geom) for pl in plans])).to(dev)
    return planes, qtabs, geom, hp


def corrupt_copies(plan, n: int, seed: int) -> list:
    """``n`` copies of ``plan`` with seeded byte flips in the scan data."""
    import copy

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = copy.copy(plan)
        scan = plan.scan_data.copy()
        pos = rng.choice(len(scan), size=3, replace=False)
        scan[pos] ^= rng.integers(1, 256, size=3).astype(np.uint8)
        p.scan_data = scan
        out.append(p)
    return out


def run() -> list[dict]:
    """All checks and the main path; returns the kernel records."""
    import torch

    from jpeg_tpu_torch import encode_rgb, runtime
    from jpeg_tpu_torch.entropy import device_huffman as k3
    from jpeg_tpu_torch.entropy import device_kernel as k4
    from jpeg_tpu_torch.entropy import device_spec as k7
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.models.decoder import (
        coefficient_planes_from_blocks,
        decode_bytes,
    )
    from jpeg_tpu_torch.ops import fused_encode as k2
    from jpeg_tpu_torch.ops import fused_plane as k1
    from jpeg_tpu_torch.ops import huffman_encode as k8
    from jpeg_tpu_torch.ops import idct_only as k56
    from jpeg_tpu_torch.parallel.pipeline import BatchedCorpusDecoder
    from jpeg_tpu_torch.tools import ablate_kernel, arith_ref, microbench
    from jpeg_tpu_torch.utils.build import build_library

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. Builds, from this checkout's sources, one compiler per library, all
    #    started together.
    def timed(load) -> float:
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    builds = (("C++ runtime (g++)", runtime.load),
              ("C++ entropy encoder (g++)", runtime.load_encoder),
              ("K1 fused_plane.cu (nvcc sm_90a)", k1.load_kernel),
              ("K2 fused_encode.cu (nvcc sm_90a)", k2.load_kernel),
              ("K8 huffman_encode.cu (nvcc sm_90a)", k8.load_kernel),
              ("K3 huffman_lanes.cu (nvcc sm_90a)", k3.load_kernel),
              ("K4 huffman_words.cu (nvcc sm_90a)", k4.load_kernel),
              ("K7 huffman_spec.cu (nvcc sm_90a)", k7.load_kernel),
              ("K5/K6 idct_only.cu (nvcc sm_90a)", k56.load_kernel),
              ("K3 pass-1 ablation tools/csrc/k3_ablate.cu (nvcc sm_90a)",
               ablate_kernel.load_kernel),
              *((f"K1 cell {t}x{n} variant (nvcc sm_90a)",
                 lambda cell=(t, n): k1.load_kernel(cell))
                for t, n in SWEEP_SHAPES),
              *((f"C++ {name} (g++, AddressSanitizer)",
                 lambda b=(name, cmd, srcs, hdrs): build_library(*b))
                for name, cmd, srcs, hdrs in runtime.ASAN_BUILDS),
              *((f"C++ microbenchmark {name} (g++)",
                 lambda name=name: microbench.build(name))
                for name in microbench.PROGRAMS),
              *((("libjpeg harness jpeg_arith_ref.c (gcc -ljpeg)",
                  arith_ref.build),) if arith_ref.find_header() else ()))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futs = [(name, pool.submit(timed, load)) for name, load in builds]
        for name, fut in futs:
            print(f"built {name} in {fut.result():.3f} s", flush=True)
    print(f"all builds (in parallel): {time.perf_counter() - t0:.3f} s",
          flush=True)

    # 2. K1 against its plain version, pixel for pixel: every sampling it
    #    takes (two small seeded images each, encoded by the port, both
    #    roundings), then each bucket of the main path: the two 512x384
    #    images and the CORPUS_4K frames.
    #    K1a, the approx tier, against its own twin to the tolerance of the
    #    tensor cores' order of sums.
    k1a_twin = TwinStats()

    def k1_check(label, plans, roundings=("truncate",)):
        planes, qtabs, geom, hp = k1_inputs(plans, dev)
        crop = (slice(None), slice(None), slice(geom.height), slice(geom.width))
        for rounding in roundings:
            out_k = k1.fused_plane_decode(planes, qtabs, geom, rounding)
            out_p = k1.fused_plane_decode_plain(planes, qtabs, geom, rounding)
            check(torch.equal(out_k, out_p), f"K1 vs plain, {label} bucket, "
                  f"{rounding}: every pixel identical")
            del out_k, out_p
            out_k = k1.fused_plane_decode(planes, qtabs, geom, rounding, "approx")
            out_p = k1.fused_plane_decode_plain(planes, qtabs, geom, rounding,
                                                "approx")
            k1a_twin.check(out_k[crop], out_p[crop], f"{label} bucket, {rounding}")
            del out_k, out_p
        return planes, qtabs, geom, hp

    def k1_work(planes, qtabs, geom, approx=False):
        """(bytes, fp32 operations, bf16 tensor-core operations) of K1 or,
        with ``approx``, K1a on these inputs."""
        h_pad, w_pad = k1.padded_size(geom)
        pixels = qtabs.shape[0] * h_pad * w_pad
        blocks = sum(p.numel() for p in planes) // 64
        n_bytes = nbytes(*planes, qtabs) + 3 * pixels
        if approx:  # K1a: the products on the tensor cores
            return (n_bytes, blocks * 64 + 12 * pixels,
                    blocks * K1A_TC_OPS_PER_BLOCK)
        return n_bytes, blocks * K1_OPS_PER_BLOCK + 12 * pixels, 0

    def k1_bound(planes, qtabs, geom, approx=False) -> dict:
        return bound(*k1_work(planes, qtabs, geom, approx))

    # K1a's machine code: the IDCT on the tensor cores, none in K1's.
    lib_path = k1.load_kernel()._name
    hmma = sass_ops(lib_path, "HMMA")
    k1a_hmma = sum(n for f, n in hmma.items() if "fused_plane_kernelILb1E" in f)
    k1_hmma = sum(n for f, n in hmma.items() if "fused_plane_kernelILb0E" in f)
    attrs = {m: k1.kernel_attributes(m) for m in ("exact", "approx")}
    check(k1a_hmma > 0 and k1_hmma == 0 and attrs["approx"]["local_bytes"] == 0,
          f"K1a's SASS holds {k1a_hmma} HMMA (tensor-core) instructions, K1's "
          f"{k1_hmma}; registers a thread K1 {attrs['exact']['registers']}, "
          f"K1a {attrs['approx']['registers']}, local (spill) bytes K1 "
          f"{attrs['exact']['local_bytes']}, K1a {attrs['approx']['local_bytes']}")

    for name, sub in K1_SAMPLINGS.items():
        imgs = [synthetic_image(520, 200, seed=seed) for seed in (5, 6)]
        streams = [encode_rgb(im[..., 0], quality=QUALITY, grayscale=True)
                   if sub is None else
                   encode_rgb(im, quality=QUALITY, subsampling=sub)
                   for im in imgs]
        k1_check(f"{name} 2x520x200", [parse_jpeg(d) for d in streams],
                 ("truncate", "round"))
    n_bad, _, _ = k1.division_mismatches(device=dev)
    check(n_bad == 0, "K1's fast x / 0.587 == IEEE division for every float "
          "with 2^-100 <= |x| <= 2^100, where K1 takes it (0 of 3.4e9 differ)")
    k1_check("512x384 no-restart", [parse_jpeg(read(SMALL_NO_RST))])
    k1_check("512x384 gray", [parse_jpeg(read(SMALL_RST[1]))])
    plans4k = [parse_jpeg(read(FRAMES_4K[i % 2])) for i in range(CORPUS_4K)]
    planes, qtabs, geom, host_planes = k1_check(f"{CORPUS_4K}x4K", plans4k)
    k1_err = 0
    k1_ms = cuda_ms(lambda: k1.fused_plane_decode(planes, qtabs, geom), 10, 2,
                    queued=True)
    k1_plain_ms = cuda_ms(lambda: k1.fused_plane_decode_plain(planes, qtabs, geom), 3, 1)
    k1_bnd = k1_bound(planes, qtabs, geom)
    print(f"K1 {CORPUS_4K}x4K bucket: kernel {k1_ms:.4f} ms, plain "
          f"{k1_plain_ms:.3f} ms (median, CUDA events); {share(k1_ms, k1_bnd)}",
          flush=True)
    k1a_bnd = k1_bound(planes, qtabs, geom, approx=True)
    k1a_ops = ops_ms(*k1_work(planes, qtabs, geom, approx=True)[1:])
    k1a = k1a_gate_and_times(planes, qtabs, geom, k1a_bnd)
    print(f"K1a {CORPUS_4K}x4K operations alone (fp32 dequantise and colour at "
          f"67 TFLOP/s, bf16 products at 989): {k1a_ops:.4f} ms", flush=True)
    # The same at one device claim's size (contiguous leading slices).
    p8, q8 = [p[:BATCH] for p in planes], qtabs[:BATCH]
    k1_8 = cuda_ms(lambda: k1.fused_plane_decode(p8, q8, geom), 10, 2,
                   queued=True)
    k1_8_plain = cuda_ms(lambda: k1.fused_plane_decode_plain(p8, q8, geom), 3, 1)
    k1_8_bnd = k1_bound(p8, q8, geom)
    print(f"K1 {BATCH}x4K: kernel {k1_8:.4f} ms, plain {k1_8_plain:.3f} ms "
          f"(median, CUDA events); {share(k1_8, k1_8_bnd)}", flush=True)
    k1a_8 = cuda_ms(lambda: k1.fused_plane_decode(p8, q8, geom,
                                                  idct_mode="approx"),
                    10, 2, queued=True)
    k1a_8_plain = cuda_ms(lambda: k1.fused_plane_decode_plain(
        p8, q8, geom, idct_mode="approx"), 3, 1)
    k1a_8_bnd = k1_bound(p8, q8, geom, approx=True)
    print(f"K1a {BATCH}x4K: kernel {k1a_8:.4f} ms, plain {k1a_8_plain:.3f} ms "
          f"(median, CUDA events); {share(k1a_8, k1a_8_bnd)}; operations "
          f"alone {ops_ms(*k1_work(p8, q8, geom, approx=True)[1:]):.4f} ms",
          flush=True)
    del planes, qtabs, p8, q8
    plans4k, host_planes = plans4k[:BATCH], host_planes[:BATCH]

    # 3. K3 against its plain version: small fixtures + corrupt copies.
    for name in SMALL_RST:
        base = parse_jpeg(read(name))
        batch = k3.prepare_lane_batch([base] + corrupt_copies(base, 8, seed=7))
        lanes = k3.lane_tensors(batch, dev)
        n = len(batch.lane_start)
        ck, ek = k3.decode_lanes(lanes, n, batch.total_rows)
        cp, ep = k3.decode_lanes_plain(lanes, n, batch.total_rows)
        check(torch.equal(ek, ep),
              f"K3 vs plain on {name} + 8 corrupt copies: err vectors equal "
              f"({int(ek.sum())} of {n} lanes flagged)")
        ok_rows = torch.zeros(batch.total_rows, dtype=torch.bool, device=dev)
        for lane in range(n):
            if not bool(ek[lane]):
                r0 = int(batch.lane_out[lane])
                ok_rows[r0 : r0 + int(batch.lane_nblk[lane])] = True
        check(torch.equal(ck[ok_rows], cp[ok_rows]),
              f"K3 vs plain on {name}: unflagged lanes bit-identical "
              f"(all rows identical: {torch.equal(ck, cp)})")

    k4_err = check_k4_small(dev)

    # 4. K3 at the main path's shape: plain version, then the C++ decoder.
    batch = k3.prepare_lane_batch(plans4k)
    lanes = k3.lane_tensors(batch, dev)
    n = len(batch.lane_start)
    ck, ek = k3.decode_lanes(lanes, n, batch.total_rows)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    cp, ep = k3.decode_lanes_plain(lanes, n, batch.total_rows)
    end.record()
    torch.cuda.synchronize()
    k3_plain_ms = start.elapsed_time(end)
    k3_err = int((ck.to(torch.int64) - cp.to(torch.int64)).abs().max())
    check(not bool(ek.any()) and torch.equal(ek, ep) and k3_err == 0,
          f"K3 vs plain on {BATCH} 4K frames ({n} lanes): no lane flagged, "
          "coefficients bit-identical")
    t0 = time.perf_counter()
    for pl in plans4k:
        runtime.native_decode_planes(pl)
    cpp_ms = (time.perf_counter() - t0) * 1e3
    for i, pl in enumerate(plans4k):
        r0, rows = batch.images[i]
        dev_planes = coefficient_planes_from_blocks(ck[r0 : r0 + rows], geom)
        for c in range(3):
            if not np.array_equal(dev_planes[c].cpu().numpy(), host_planes[i][c]):
                raise CheckFailed(f"K3 planes of frame {i}, component {c} "
                                  "differ from the C++ decoder")
    check(True, f"K3 on {BATCH} 4K frames == C++ native_decode_planes, bit for bit")
    print(f"K3 {BATCH}x4K ({n} lanes): plain {k3_plain_ms:.1f} ms; C++ "
          f"runtime {cpp_ms:.3f} ms per batch ({os.cpu_count()} threads per "
          "frame, host clock)", flush=True)
    del cp
    k3_time = {}  # frames -> (ms, bound)
    for frames in K3_FRAMES:
        b = batch if frames == BATCH else k3.prepare_lane_batch(
            [parse_jpeg(read(FRAMES_4K[i % 2])) for i in range(frames)])
        t = lanes if frames == BATCH else k3.lane_tensors(b, dev)
        m = len(b.lane_start)
        ms = cuda_ms(lambda: k3.decode_lanes(t, m, b.total_rows), 5, 1,
                     queued=True)
        bnd = bound(nbytes(*(t[k] for k in K3_INPUTS)) + b.total_rows * 256 + m)
        k3_time[frames] = (ms, bnd)
        print(f"K3 {frames}x4K ({m} lanes): kernel {ms:.4f} ms (median, CUDA "
              f"events); {share(ms, bnd)}", flush=True)
        del t
    k3_ms, k3_bnd = k3_time[BATCH]
    k4_8, k4_8_bnd = check_k4_4k(plans4k, host_planes, geom, ck, batch, k3_ms,
                                 dev)
    del ck, lanes

    # 4b. K3 under every device-entropy tier name, on the same claim.
    t0 = time.perf_counter()
    k3_names = entropy_names(plans4k, dev)
    print(f"entropy-names phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # 4c. K7: the speculative chunk-lane decode of a frame without restarts.
    t0 = time.perf_counter()
    k7_rec = speculative(dev, card)
    print(f"speculative phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # 5. The main path: hybrid corpus decode.
    items = [read(SMALL_NO_RST), read(SMALL_RST[1])] + [
        read(FRAMES_4K[i % 2]) for i in range(CORPUS_4K)]
    warm = BatchedCorpusDecoder(hybrid_device=True, device_batch=BATCH)
    warm.decode_all(items[:2] + items[2 : 2 + 4 * BATCH])
    warm.close()
    dec = BatchedCorpusDecoder(hybrid_device=True, device_batch=BATCH,
                               device="cuda")
    k1.LAUNCHES.reset()
    k3.LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hybrid = dec.decode_all(items)
    wall = time.perf_counter() - t0
    k1_launches, k3_launches = k1.LAUNCHES.value, k3.LAUNCHES.value
    dec.close()
    check(all(r.ok for r in hybrid),
          f"main path: all {len(items)} items decoded "
          f"({[r.error for r in hybrid if not r.ok]})")
    check(dec.device_frames > 0 and k1_launches > 0 and k3_launches > 0,
          f"main path went through the kernels: K1 launches {k1_launches}, "
          f"K3 launches {k3_launches}, device-decoded frames {dec.device_frames}, "
          f"fallbacks {dec.fallback_frames}")
    fps = len(items) / wall
    print(f"main path: {len(items)} frames ({CORPUS_4K} at 3840x2160) in "
          f"{wall:.3f} s = {fps:.2f} frames/s, transfers included; device "
          f"share {dec.device_frames / len(items):.3f}", flush=True)

    host = BatchedCorpusDecoder(hybrid_device=False, device="cuda")
    t0 = time.perf_counter()
    host_res = host.decode_all(items)
    host_wall = time.perf_counter() - t0
    host.close()
    print(f"host-entropy route, same corpus: {host_wall:.3f} s = "
          f"{len(items) / host_wall:.2f} frames/s", flush=True)
    check(all(h.ok and np.array_equal(h.rgb, g.rgb)
              for h, g in zip(host_res, hybrid)),
          "hybrid route == host route, every frame bit for bit")
    single = decode_bytes(items[-1], path="fast", device="cuda")
    check(np.array_equal(single, hybrid[-1].rgb),
          "decode_bytes(path='fast', device='cuda') == batched result")
    sources = [synthetic_image(3840, 2160, seed=seed) for seed in (0, 1)]
    for k in (2, 3):
        seed = k % 2
        want = sources[seed]
        got = hybrid[k].rgb
        p = psnr(got, want)
        check(got.shape == (2160, 3840, 3) and p > 30.0,
              f"4K frame seed {seed}: shape {got.shape}, PSNR vs its source "
              f"image {p:.2f} dB > 30")
    for k, name in ((0, SMALL_NO_RST), (1, SMALL_RST[1])):
        seed = int(name.split("_s")[1].split("_")[0])
        want = synthetic_image(512, 384, seed=seed)
        if "gray" in name:
            want = np.repeat(np.round(want.astype(np.float64) @ [0.299, 0.587, 0.114])
                             .clip(0, 255).astype(np.uint8)[..., None], 3, axis=2)
        p = psnr(hybrid[k].rgb, want)
        check(p > 30.0, f"{name}: PSNR vs its source image {p:.2f} dB > 30")

    # 5b. The scale-out layer: the sharded routes under meshes.
    t0 = time.perf_counter()
    scale = scale_out(dev, card, items, hybrid, host_res, sources)
    print(f"scale-out phase: {time.perf_counter() - t0:.1f} s", flush=True)
    del host_res

    # 6.-8. The encoder: K2 against its plain version, the encode path, and
    #    encode -> decode.
    frames = [sources[i % 2] for i in range(BATCH)]
    k2_rec = check_k2(frames, dev)
    k8_rec = check_huffman_encode(frames, dev)
    streams, k2_launches, k8_launches = encode_path(frames)
    k1_rt_launches, k3_rt_launches = round_trip(streams, sources)

    # 9. The single-frame device-entropy decode (K4 -> planes -> K1).
    k4_launches, k4_4k_err, k4_ms, k4_plain_ms, k4_bnd = single_frame_path(
        read(FRAMES_4K[0]), dev)

    # 10. decode_bytes' default route, the compat decode.
    compat_path()

    # 11. Every other stream kind: single images, then the mixed corpus.
    t0 = time.perf_counter()
    k1_mixed_launches, k3_mixed_launches = every_stream_path()
    print(f"every-stream phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # 11b. 12-bit and lossless decode, and the encoders that write them.
    t0 = time.perf_counter()
    formats(dev, card)
    print(f"formats phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # 12. K5 and K6 at the roofline instrument's shape.
    k5, k6 = idct_roofline(dev)

    # 13. The command line: corpus (exact, resumed, approx), decode, encode,
    #     info, python -m, and a device trace.
    cli = cli_path(dev, k1a_twin)
    print(f"K1a vs plain over every comparison: max |diff| {k1a_twin.max} u8, "
          f"{k1a_twin.differ} of {k1a_twin.values} values differ, smallest "
          f"frame PSNR {k1a_twin.min_psnr:.2f} dB", flush=True)

    # 13b. The approx tier's quality gate over the corpus matrix, through
    #      the port's tool.
    t0 = time.perf_counter()
    approx_quality = approx_quality_phase()
    print(f"approx quality phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # 13c. The endurance tool: the command line in child processes, killed
    #      and resumed.
    t0 = time.perf_counter()
    endurance_phase(card)
    print(f"endurance phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # 13d. The kernel-study tools: the corrupt-stream fuzz of every route
    #      (and under compute-sanitizer), K7's ladder, K3's pass-1
    #      ablation, K1's cell sweep.
    t0 = time.perf_counter()
    tools = tools_phase(dev, card)
    print(f"tools phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # 13e. The host C++ runtime and the host tools: speculative planes at
    #      three chunk counts, the quick A/B modes, the C++ microbenchmarks,
    #      libjpeg's QM-coder ground truth and the AddressSanitizer sweep.
    t0 = time.perf_counter()
    host_runtime_phase(card)
    print(f"host_runtime phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # 14. The port's bench (jpeg_tpu_torch/bench.py) in a quick mode.
    t0 = time.perf_counter()
    bench = bench_phase(card)
    print(f"bench phase: {time.perf_counter() - t0:.1f} s", flush=True)

    print(card, flush=True)  # nvidia-smi name, power limit
    # "launches" counts the main path's run (the hybrid corpus decode for
    # K1 and K3); the round trip's own counts are kept beside them.
    return [
        {"name": "K1 fused_plane", "route": "cuda",
         "source": "jpeg_tpu_torch/csrc/fused_plane.cu",
         "replaces": "jpeg_tpu/ops/pallas_kernels.py:215",
         "launches": k1_launches, "launches_round_trip": k1_rt_launches,
         "launches_mixed_corpus": k1_mixed_launches,
         "launches_cli_corpus": cli["k1"],
         "launches_scale_out": {k: v["K1"] for k, v in scale["launches"].items()},
         "launches_bench": bench["K1"],
         "launches_approx_quality": approx_quality["k1"],
         "launches_tools": tools["K1"],
         "scale_out_ms": {k: v for k, v in scale.items() if k != "launches"},
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         **k1_bnd, "library_ms": None, "frames": CORPUS_4K,
         "registers": attrs["exact"]["registers"],
         "ms_8_frames": k1_8, "bound_ms_8_frames": k1_8_bnd["bound_ms"]},
        {"name": "K1a fused_plane approx", "route": "cuda",
         "source": "jpeg_tpu_torch/csrc/fused_plane.cu",
         "replaces": "jpeg_tpu/ops/pallas_kernels.py:301",
         "launches": cli["k1a"], "launches_bench": bench["K1a"],
         "launches_approx_quality": approx_quality["k1a"],
         "launches_tools": tools["K1a"],
         "max_abs_err": k1a_twin.max,
         "twin_differing_share": k1a_twin.differ / k1a_twin.values,
         # null: every frame equal to the twin's
         "twin_min_psnr_db": (None if k1a_twin.min_psnr == float("inf")
                              else k1a_twin.min_psnr),
         "tensor_cores": True,
         "hmma_instructions": k1a_hmma,
         "registers": attrs["approx"]["registers"],
         "local_bytes": attrs["approx"]["local_bytes"],
         "ms": k1a["ms"], "plain_ms": k1a["plain_ms"], **k1a_bnd,
         "bound_ops_ms": k1a_ops,
         "library_ms": None, "frames": CORPUS_4K, "ms_8_frames": k1a_8,
         "plain_ms_8_frames": k1a_8_plain,
         "bound_ms_8_frames": k1a_8_bnd["bound_ms"],
         "vs_k1_max_abs_diff": k1a["max_diff"],
         "vs_k1_min_psnr_db": k1a["min_psnr"]},
        {"name": "K2 fused_encode", "route": "cuda",
         "source": "jpeg_tpu_torch/csrc/fused_encode.cu",
         "replaces": "jpeg_tpu/ops/pallas_kernels.py:410",
         "launches": k2_launches, "launches_bench": bench["K2"], **k2_rec,
         "library_ms": None,
         "launches_scale_out": {k: v["K2"] for k, v in scale["launches"].items()}},
        {"name": "K8 huffman_encode", "route": "cuda",
         "source": "jpeg_tpu_torch/csrc/huffman_encode.cu",
         "replaces": None, "launches": k8_launches, **k8_rec,
         "library_ms": None},
        {"name": "K3 huffman_lanes", "route": "cuda",
         "source": "jpeg_tpu_torch/csrc/huffman_lanes.cu",
         "replaces": "jpeg_tpu/entropy/device_window.py:175",
         "launches": k3_launches, "launches_round_trip": k3_rt_launches,
         "launches_mixed_corpus": k3_mixed_launches,
         "launches_cli_corpus": cli["k3"],
         "launches_entropy_names": k3_names, "launches_bench": bench["K3"],
         "launches_tools": tools["K3"],
         "launches_scale_out": {k: v["K3"] for k, v in scale["launches"].items()},
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
         **k3_bnd, "library_ms": None, "frames": BATCH,
         "ms_by_frames": {str(f): t[0] for f, t in k3_time.items()},
         "bound_ms_by_frames": {str(f): t[1]["bound_ms"]
                                for f, t in k3_time.items()}},
        {"name": "K4 huffman_words", "route": "cuda",
         "source": "jpeg_tpu_torch/csrc/huffman_words.cu",
         "replaces": "jpeg_tpu/entropy/device_kernel.py:251",
         "launches": k4_launches, "launches_tools": tools["K4"],
         "max_abs_err": max(k4_err, k4_4k_err),
         "ms": k4_ms, "plain_ms": k4_plain_ms, **k4_bnd, "library_ms": None,
         "frames": 1, "ms_8_frames": k4_8,
         "bound_ms_8_frames": k4_8_bnd["bound_ms"]},
        {**k7_rec, "launches_tools": tools["K7"]},
        {"name": "K5 idct_only", "route": "cuda",
         "source": "jpeg_tpu_torch/csrc/idct_only.cu",
         "replaces": "jpeg_tpu/ops/pallas_kernels.py:362", **k5,
         "launches_bench": bench["K5"]},
        {"name": "K6 idct_only_roll", "route": "cuda",
         "source": "jpeg_tpu_torch/csrc/idct_only.cu",
         "replaces": "jpeg_tpu/ops/pallas_kernels.py:327", **k6},
    ]


def k1a_gate_and_times(planes, qtabs, geom, bnd) -> dict:
    """K1a on the main path's 4K bucket: within docs/APPROX_QUALITY.md's
    gate of exact K1 on every frame (max |diff| <= 2 u8, >= 50 dB over the
    cropped frame), then timed queued beside its plain twin. Returns ms,
    plain_ms, the largest difference and the smallest PSNR."""
    import torch

    from jpeg_tpu_torch.ops import fused_plane as k1

    exact = k1.fused_plane_decode(planes, qtabs, geom)
    approx = k1.fused_plane_decode(planes, qtabs, geom, idct_mode="approx")
    worst, min_psnr = 0, float("inf")
    for b in range(exact.shape[0]):
        e = exact[b, :, : geom.height, : geom.width].float()
        d = approx[b, :, : geom.height, : geom.width].float() - e
        worst = max(worst, int(d.abs().max()))
        mse = float((d * d).mean())
        min_psnr = min(min_psnr, float("inf") if mse == 0
                       else 10.0 * np.log10(255.0**2 / mse))
    differ = int((approx != exact).sum())
    del exact, approx
    check(worst <= APPROX_MAX_DIFF and min_psnr >= APPROX_MIN_PSNR,
          f"K1a vs K1 on {planes[0].shape[0]} 4K frames: max |diff| {worst} "
          f"<= {APPROX_MAX_DIFF} u8, smallest PSNR {min_psnr:.2f} dB >= "
          f"{APPROX_MIN_PSNR} ({differ} values differ)")
    ms = cuda_ms(lambda: k1.fused_plane_decode(planes, qtabs, geom,
                                               idct_mode="approx"),
                 10, 2, queued=True)
    plain_ms = cuda_ms(lambda: k1.fused_plane_decode_plain(
        planes, qtabs, geom, idct_mode="approx"), 3, 1)
    print(f"K1a {planes[0].shape[0]}x4K bucket: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms (median, CUDA events); {share(ms, bnd)}",
          flush=True)
    torch.cuda.synchronize()
    return {"ms": ms, "plain_ms": plain_ms, "max_diff": worst,
            "min_psnr": min_psnr}


def cli_path(dev, k1a_twin: TwinStats) -> dict:
    """The command line, in process (``jpeg_tpu_torch.cli.main``, so the
    launch counters can be read) on the main path's 64 items written to a
    temporary directory:

    - ``corpus --batched --hybrid-device --manifest``: every item decoded,
      through K1 and K3, with the ``stages`` report;
    - a fresh manifest run with ``--limit 24``, again, then without a limit:
      the reports add up to every item, each in the manifest once;
    - ``corpus --idct approx``: every item through K1a; then in process,
      ``BatchedCorpusDecoder`` exact and approx on the same files, every
      frame within the approx gate, and the approx frames within the
      order-of-sums tolerance of K1a's plain twin (added to ``k1a_twin``);
    - ``decode`` of a 4K frame to P6 on the fast path (exact and approx) and
      the compat default, each equal to ``decode_bytes``; ``--engine
      oracle`` on a 512x384 image equal to the native engine;
    - ``encode`` of a P6 written by ``write_ppm`` equal to ``encode_rgb``;
    - ``info`` of a 4K frame, in process and as ``python -m
      jpeg_tpu_torch`` in a subprocess;
    - one K1 launch inside ``device_trace``: its trace names K1's kernel.

    Returns the exact corpus' K1 and K3 launches and the approx corpus' K1a
    launches."""
    import contextlib
    import io
    import tempfile

    import torch

    from jpeg_tpu_torch import cli, decode_bytes, encode_rgb
    from jpeg_tpu_torch.entropy import device_huffman as k3
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.io.ppm import read_ppm, write_ppm
    from jpeg_tpu_torch.ops import fused_plane as k1
    from jpeg_tpu_torch.parallel.pipeline import BatchedCorpusDecoder
    from jpeg_tpu_torch.utils.profiling import device_trace

    def run_cli(argv, what):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        out = buf.getvalue().strip().splitlines()
        check(rc == 0, f"cli {what}: exit code 0")
        return out[-1] if out else ""

    def reset():
        for counter in (k1.LAUNCHES, k1.LAUNCHES_APPROX, k3.LAUNCHES):
            counter.reset()
        torch.cuda.synchronize()

    def counts():
        return (k1.LAUNCHES.value, k1.LAUNCHES_APPROX.value, k3.LAUNCHES.value)

    names = [SMALL_NO_RST, SMALL_RST[1]] + [FRAMES_4K[i % 2]
                                            for i in range(CORPUS_4K)]
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        os.makedirs(corpus)
        paths = []
        for i, name in enumerate(names):
            paths.append(os.path.join(corpus, f"item_{i:03d}.jpg"))
            with open(paths[-1], "wb") as f:
                f.write(read(name))
        n = len(paths)
        base = ["corpus", corpus, "--batched", "--hybrid-device"]

        reset()
        report = json.loads(run_cli(
            base + ["--manifest", os.path.join(tmp, "m1")], "corpus"))
        k1_n, k1a_n, k3_n = counts()
        launches.update(k1=k1_n, k3=k3_n)
        check(report["decoded"] == n and report["failed"] == 0
              and set(report["stages"]) == {"decode"},
              f"cli corpus --batched --hybrid-device: {report['decoded']} of "
              f"{n} decoded, {report['failed']} failed; stages "
              f"{json.dumps(report['stages'])}")
        check(k1_n > 0 and k3_n > 0 and k1a_n == 0,
              f"cli corpus went through the kernels: K1 launches {k1_n}, K3 "
              f"launches {k3_n}, K1a {k1a_n}")
        print(f"cli corpus: {n} items ({CORPUS_4K} at 3840x2160) in "
              f"{report['wall_s']} s = {report['frames_per_s']} frames/s "
              "(its own report, host clock)", flush=True)

        m2 = os.path.join(tmp, "m2")
        parts = [json.loads(run_cli(base + ["--manifest", m2] + extra,
                                    f"corpus resume {k}"))["decoded"]
                 for k, extra in enumerate((["--limit", "24"], ["--limit", "24"],
                                            []))]
        with open(f"{m2}.0.jsonl") as f:
            done = [json.loads(line)["item"] for line in f]
        check(parts == [24, 24, n - 48] and sorted(done) == sorted(paths),
              f"cli corpus resumed with --limit 24: decoded {parts}, the "
              f"manifest holds each of the {n} items once ({len(done)} lines)")

        reset()
        report = json.loads(run_cli(base + ["--idct", "approx"],
                                    "corpus --idct approx"))
        k1_n, k1a_n, k3_n = counts()
        launches["k1a"] = k1a_n
        check(report["decoded"] == n and report["failed"] == 0
              and k1a_n > 0 and k1_n == 0 and k3_n > 0,
              f"cli corpus --idct approx: {report['decoded']} of {n} decoded "
              f"through K1a ({k1a_n} launches, K1 {k1_n}, K3 {k3_n})")
        print(f"cli corpus --idct approx: {n} items in {report['wall_s']} s = "
              f"{report['frames_per_s']} frames/s (its own report, host clock)",
              flush=True)
        results = {}
        for mode in ("exact", "approx"):
            dec = BatchedCorpusDecoder(hybrid_device=True, idct_mode=mode,
                                       device=dev)
            results[mode] = dec.decode_all(paths)
            dec.close()
        worst, min_psnr = 0, float("inf")
        for e, a in zip(results["exact"], results["approx"]):
            worst = max(worst, int(np.abs(a.rgb.astype(np.int16)
                                          - e.rgb.astype(np.int16)).max()))
            min_psnr = min(min_psnr, psnr(a.rgb, e.rgb))
        check(all(r.ok for rs in results.values() for r in rs)
              and worst <= APPROX_MAX_DIFF and min_psnr >= APPROX_MIN_PSNR,
              f"BatchedCorpusDecoder(idct_mode='approx') on the cli corpus: "
              f"every frame within {APPROX_MAX_DIFF} u8 (max {worst}) and "
              f"{APPROX_MIN_PSNR} dB (min {min_psnr:.2f}) of the exact run")
        twins = {}  # K1a's plain twin on the card, once per distinct file
        for name in dict.fromkeys(names):
            planes, qtabs, geom, _ = k1_inputs([parse_jpeg(read(name))], dev)
            twins[name] = k1.fused_plane_decode_plain(
                planes, qtabs, geom, idct_mode="approx")[
                    0, :, : geom.height, : geom.width].permute(1, 2, 0)
        for name, res in zip(names[:2], results["approx"]):
            k1a_twin.check(torch.as_tensor(res.rgb, device=dev)[None],
                           twins[name][None],
                           f"BatchedCorpusDecoder(idct_mode='approx'), {name}")
        k1a_twin.check(
            torch.stack([torch.as_tensor(r.rgb, device=dev)
                         for r in results["approx"][2:]]),
            torch.stack([twins[n] for n in names[2:]]),
            f"BatchedCorpusDecoder(idct_mode='approx'), the cli corpus's "
            f"{len(names) - 2} 4K frames")
        approx_4k = results["approx"][2].rgb
        del results, twins

        frame = paths[2]
        data = read(names[2])
        out = os.path.join(tmp, "frame.ppm")
        for opts, want, label in (
                (["--path", "fast"], decode_bytes(data, path="fast", device=dev),
                 "decode_bytes(path='fast')"),
                (["--path", "fast", "--idct", "approx"], approx_4k,
                 "the in-process approx decode"),
                ([], decode_bytes(data, device=dev), "decode_bytes()")):
            run_cli(["decode", frame, out, *opts], f"decode {opts}")
            got = read_ppm(out)
            check(got.shape == (2160, 3840, 3) and np.array_equal(got, want),
                  f"cli decode {' '.join(opts) or '(compat)'} of a 4K frame to "
                  f"P6 == {label}")
        small = paths[0]
        run_cli(["decode", small, out, "--engine", "oracle"], "decode oracle")
        check(np.array_equal(read_ppm(out), decode_bytes(
            read(names[0]), engine="native", device=dev)),
              f"cli decode --engine oracle of {names[0]} == the native engine")

        src = os.path.join(tmp, "src.ppm")
        img = synthetic_image(3840, 2160, seed=0)
        write_ppm(src, img)
        jpg = os.path.join(tmp, "enc.jpg")
        run_cli(["encode", src, jpg, "--restart-interval", str(RESTART_4K)],
                "encode")
        with open(jpg, "rb") as f:
            check(f.read() == encode_rgb(img, restart_interval_mcus=RESTART_4K),
                  "cli encode of a 4K P6 (write_ppm) == encode_rgb, byte for "
                  "byte")

        info = json.loads(run_cli(["info", frame], "info"))
        check(info["width"] == 3840 and info["height"] == 2160
              and info["entropy_segments"] == 135,
              f"cli info of a 4K frame: {info['width']}x{info['height']}, "
              f"{info['entropy_segments']} entropy segments")
        env = dict(os.environ, PYTHONPATH=REPO)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "jpeg_tpu_torch", "info",
                               frame], cwd=tmp, env=env, capture_output=True,
                              text=True, timeout=300)
        check(proc.returncode == 0
              and json.loads(proc.stdout.strip().splitlines()[-1]) == info,
              f"python -m jpeg_tpu_torch info: the same JSON "
              f"({time.perf_counter() - t0:.1f} s, a fresh interpreter)")

        planes, qtabs, geom, _ = k1_inputs([parse_jpeg(data)], dev)
        trace_dir = os.path.join(tmp, "trace")
        reset()
        with device_trace(trace_dir):
            k1.fused_plane_decode(planes, qtabs, geom)
            torch.cuda.synchronize()
        traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
                  if f.endswith(".pt.trace.json")]
        text = "".join(open(t).read() for t in traces)
        check(k1.LAUNCHES.value == 1 and len(traces) == 1
              and "fused_plane_kernel" in text,
              f"device_trace: one K1 launch, {len(traces)} trace file naming "
              "fused_plane_kernel")
    return launches


def approx_quality_phase() -> dict:
    """``jpeg_tpu_torch.tools.measure_approx_quality.main`` on the card: its
    six synthetic cases (4K q70 / q85 / q95, 1080p q85, gray 1080p q90,
    4:4:4 1080p q92) each through K1 and K1a, its table printed among these
    lines, the worst case inside docs/APPROX_QUALITY.md's gate. Returns the
    launches of K1 and K1a."""
    from jpeg_tpu_torch.ops import fused_plane as k1
    from jpeg_tpu_torch.tools import measure_approx_quality as maq

    for counter in (k1.LAUNCHES, k1.LAUNCHES_APPROX):
        counter.reset()
    rc = maq.main([])
    launches = {"k1": k1.LAUNCHES.value, "k1a": k1.LAUNCHES_APPROX.value}
    n = len(maq.CASES)
    check(rc == 0, f"measure_approx_quality: the worst of its {n} cases "
          f"within the gate (exit code {rc})")
    check(launches["k1"] >= n and launches["k1a"] >= n,
          f"measure_approx_quality went through the kernels: K1 "
          f"{launches['k1']}, K1a {launches['k1a']} launches for {n} cases")
    return launches


def endurance_phase(card: str) -> dict:
    """``jpeg_tpu_torch.tools.endurance.main`` on the main path's 62 4K
    frames, written to a temporary directory, in child processes of the
    command line: a short pass of 16, the whole corpus killed at 16 images
    done, recycled ``--limit 24`` segments, ``--chunk-size 8``, and a CPU
    control of 12 images in chunks of 4 (three samples, so that its growth
    is computed). Its JSON record is printed on a line of its own. Every
    fault raises: a child that fails, a kill outside the corpus, a segment
    with a failed image, images after the kill not decoded once, the
    card's memory not read, no control growth, or a verdict that does not
    follow the tool's gate. Both halves of the gate are printed, not held:
    two processes at this size differ by up to 13% in steady frames/s with
    no trend (5 of 20 such runs on the H100 fell under 0.9), and the
    control's RSS moved by -110 to +379 MB between its samples in those
    runs, up to ~95 MB an image at chunks of 4 (PERF.md). Returns the
    record."""
    import tempfile

    import torch

    from jpeg_tpu_torch.tools import endurance

    torch.cuda.empty_cache()  # the children read the card's memory
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        os.makedirs(corpus)
        for i in range(CORPUS_4K):
            with open(os.path.join(corpus, f"img_{i:05d}.jpg"), "wb") as f:
                f.write(read(FRAMES_4K[i % 2]))
        out = os.path.join(tmp, "sustained.json")
        try:
            rc = endurance.main([
                "--images", str(CORPUS_4K), "--corpus", corpus, "--short",
                "16", "--kill-after", "16", "--limit", "24", "--chunk-size",
                "8", "--control-images", "12", "--control-chunk", "4",
                "--out", out, "--timeout", "300"])
        except RuntimeError as e:
            raise CheckFailed(f"endurance: {e}") from e
        with open(out) as f:
            record = json.load(f)
    segs = record["segments"]
    decay = record["steady_state_decay"]
    growth = record["control_cpu_rss_plateau_mb_per_image"]
    check(growth is not None
          and rc == (0 if endurance.passes(decay, growth) else 1),
          f"endurance: control growth {growth} MB an image computed, exit "
          f"code {rc} follows the gate")
    print(f"endurance: steady-state decay {decay} (segments "
          f"{[s['fps_steady'] for s in segs]} frames/s; gate >= "
          f"{endurance.MIN_DECAY}), control growth {growth} MB an image "
          f"(RSS {record['control_cpu_rss_mb']} MB; gate <= "
          f"{endurance.MAX_CONTROL_GROWTH_MB}): the tool's verdict "
          f"{'PASS' if rc == 0 else 'FAIL'}, not held here", flush=True)
    killed = record["killed_after_images"]
    check(0 < killed < CORPUS_4K and all(s["failed"] == 0 for s in segs)
          and sum(s["decoded"] for s in segs) == CORPUS_4K - killed
          and all(s["gpu_mem_max_mb"] for s in segs)
          and record["card"] == card and record["resolution"] == "3840x2160",
          f"endurance: killed after {killed} of {CORPUS_4K}, segments "
          f"{[s['decoded'] for s in segs]} without a failure, card memory "
          f"{[s['gpu_mem_max_mb'] for s in segs]} MB "
          f"({segs[0]['gpu_mem_source']}), card {record['card']!r}")
    return record


def tools_phase(dev, card: str) -> dict:
    """The port's kernel-study tools (``jpeg_tpu_torch/tools/``), with the
    launch counters set to 0 just before and read just after:

    - ``fuzz.run`` over seeds FUZZ_SEEDS of its 20 variants, every route:
      the oracle and native engines on the card, K1 (fast path) against
      the CPU, K3 and K4 against their twins and the C++ decoder, K7
      against the C++ decoder, and the hybrid corpus decoder with each case
      in a claim of 4K frames; no problem, and every kernel route reached
      by a case (K3 taking the case itself on the corpus route);
    - the two-sentinel check of K3, K4 and K7 over the damaged cases of
      SENTINEL_SEEDS (``sentinel.check``): every entry a consumer reads
      equal when their ``torch.empty`` outputs start as two different
      bytes;
    - the same seeds' device routes in a child process under
      ``compute-sanitizer --tool memcheck --error-exitcode 1``, found
      beside nvcc (a missing tool is printed, not hidden);
    - ``bench_device_spec.run`` at LADDER_CONFIGS on both of its frames,
      each bit for bit with the C++ decoder;
    - ``ablate_kernel.ablate`` variants (a) and (b) on the 2,025-lane
      stream, (a) equal to the shipping pass 1's records;
    - ``sweep_tiles.sweep`` at SWEEP_SHAPES on 8 4K frames, K1 and K1a
      bit-identical to the shipping cell.

    Returns the launches by kernel."""
    import torch

    from jpeg_tpu_torch.entropy import device_huffman as k3
    from jpeg_tpu_torch.entropy import device_kernel as k4
    from jpeg_tpu_torch.entropy import device_spec as k7
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.ops import fused_plane as k1
    from jpeg_tpu_torch.runtime import native_decode_coefficients
    from jpeg_tpu_torch.tools import ablate_kernel, bench_device_spec, fuzz
    from jpeg_tpu_torch.tools import sentinel, sweep_tiles
    from jpeg_tpu_torch.utils.build import find_nvcc

    counters = {"K1": k1.LAUNCHES, "K1a": k1.LAUNCHES_APPROX,
                "K3": k3.LAUNCHES, "K4": k4.LAUNCHES, "K7": k7.LAUNCHES}
    for c in counters.values():
        c.reset()
    lo, hi = FUZZ_SEEDS
    t0 = time.perf_counter()
    lines = []
    summary = fuzz.run(lo, hi, dev, out=lines.append)
    for line in lines:
        if '"problems": []' not in line:
            print(f"fuzz case: {line}", flush=True)
    print(f"fuzz summary ({card}): {json.dumps(summary)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(summary["problems"] == 0 and not summary["unreached"]
          and summary["cases"] == 20 * (hi - lo),
          f"fuzz [{lo},{hi}) x {summary['variants']} variants: "
          f"{summary['problems']} problems; cases that launched each kernel "
          f"{summary['launched']} of those taken {summary['taken']}; corpus "
          f"claims {summary['claims']}")

    # The check compute-sanitizer cannot make here: K3, K4 and K7 over the
    # same damaged cases, their torch.empty outputs pre-filled with two
    # different bytes, every entry a consumer reads equal.
    t0 = time.perf_counter()
    sent = sentinel.check(dev, range(*SENTINEL_SEEDS))
    print(f"two-sentinel check ({card}): {json.dumps(sent)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(all(r["cases"] > 0 and not r["read_differ"]
              and r["launches"] >= 2 * r["cases"] for r in sent.values()),
          f"two sentinels, fuzz {list(range(*SENTINEL_SEEDS))}: every "
          f"entry read equal for "
          + ", ".join(f"{k} ({r['cases']} damaged cases, {r['launches']} "
                      f"launches)" for k, r in sent.items()))

    sanitizer = os.path.join(os.path.dirname(find_nvcc()), "compute-sanitizer")
    if not os.path.exists(sanitizer):
        print(f"compute-sanitizer: not in the CUDA toolkit ({sanitizer} "
              "does not exist): the fuzz's device routes ran without it",
              flush=True)
    else:
        t0 = time.perf_counter()
        cmd = [sanitizer, "--tool", "memcheck", "--error-exitcode", "1",
               sys.executable, "-m", "jpeg_tpu_torch.tools.fuzz", str(lo),
               str(hi), "--clean-size", SANITIZER_CLEAN, "--no-twins"]
        proc = subprocess.run(
            cmd, cwd=REPO, capture_output=True, text=True,
            timeout=SANITIZER_TIMEOUT_S,
            env={**os.environ, "PYTORCH_NO_CUDA_MEMORY_CACHING": "1"})
        lines = (proc.stdout + proc.stderr).splitlines()
        said = [ln for ln in lines if ln.startswith("========= ")
                and "Host Frame" not in ln]
        print("\n".join(f"memcheck: {ln}" for ln in said[:12]), flush=True)
        if any(ln.strip() == REFUSED_BY_SANITIZER for ln in said):
            # The sanitizer refuses this card (compute-sanitizer 2025.2.1
            # and an NVIDIA H100 80GB HBM3): every CUDA call of the child
            # then fails, and nothing is checked. Printed, with the tool's
            # own line, never passed.
            print(f"compute-sanitizer refuses this card ({card}): "
                  f"{REFUSED_BY_SANITIZER!r}; memcheck did not run the "
                  f"fuzz's device routes ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        else:
            check(proc.returncode == 0
                  and any("ERROR SUMMARY: 0 errors" in ln for ln in said),
                  f"fuzz [{lo},{hi}) device routes under compute-sanitizer "
                  f"memcheck: exit code {proc.returncode}, 0 errors "
                  f"({time.perf_counter() - t0:.1f} s; last lines "
                  f"{lines[-3:]})")

    from jpeg_tpu_torch.bench import SIZE_4K

    for tag, data in bench_device_spec.frames(SIZE_4K):
        plan = parse_jpeg(data)
        ref = native_decode_coefficients(plan, reuse_buffer=False)
        for lanes, overlap in LADDER_CONFIGS:
            r = bench_device_spec.run(plan, lanes, overlap, 3, dev)
            exact = r["coeffs"] is not None and np.array_equal(
                r["coeffs"].cpu().numpy(), ref)
            check(exact, f"K7 ladder ({card}), {tag} {lanes}:{overlap}: "
                  f"lanes {r['stats']['lanes']}, cap {r['stats']['cap']}, "
                  f"gap_mcus {r['stats']['gap_mcus']}, whole call "
                  f"{r['ms']} ms, K7 {r['k7_ms']} ms (median), == C++")

    recs = ablate_kernel.ablate(ablate_kernel.stream_plans("rst16", dev),
                                ("a", "b"), 10, dev)
    for rec in recs:
        print(f"K3 pass-1 ablation ({card}): {json.dumps(rec)}", flush=True)
    full = recs[0]
    check(full["variant"] == "a" and full["same_records"]
          and full["lanes"] == 2025,
          f"K3 pass-1 ablation: (a) full on {full['lanes']} lanes writes the "
          f"shipping pass 1's records and flags, {full['ms']:.4f} ms; (b) no "
          f"record store {recs[1]['ratio_to_full']:.3f} of it")

    recs = sweep_tiles.sweep(SWEEP_SHAPES, (BATCH,), 5, dev)
    for rec in recs:
        print(f"K1 cell sweep ({card}): {json.dumps(rec)}", flush=True)
    check(all(r["k1"]["identical"] and r["k1a"]["identical"] for r in recs),
          f"K1 cell sweep at {BATCH} 4K frames: cells {list(SWEEP_SHAPES)} "
          "give the shipping cell's pixels, K1 and K1a bit for bit")
    torch.cuda.synchronize()
    return {name: c.value for name, c in counters.items()}


def check_k4_small(dev) -> int:
    """K4 against its plain version on the small restart fixtures plus 8
    corrupt copies each, one batch launch per fixture: equal error vectors,
    unflagged lanes bit-identical. Returns the max abs err over unflagged
    lanes."""
    import torch

    from jpeg_tpu_torch.entropy import device_kernel as k4
    from jpeg_tpu_torch.io.container import parse_jpeg

    worst = 0
    for name in SMALL_RST:
        base = parse_jpeg(read(name))
        plans = [base] + corrupt_copies(base, 8, seed=11)
        run, args, max_mcus, n, _ = k4.kernel_runner_batch(plans, device=dev)
        consts = k4.kernel_constants(base, dev)
        out_k, err_k = run(*args)
        out_p, err_p = k4.decode_words_plain(*args, *consts, max_mcus)
        check(torch.equal(err_k, err_p),
              f"K4 vs plain on {name} + 8 corrupt copies: err vectors equal "
              f"({int(err_k.sum())} of {n} lanes flagged)")
        ok = ~err_k[0]
        diff = (out_k[..., ok].to(torch.int64) - out_p[..., ok].to(torch.int64))
        worst = max(worst, int(diff.abs().max()) if diff.numel() else 0)
        check(worst == 0,
              f"K4 vs plain on {name}: unflagged lanes bit-identical "
              f"(all lanes identical: {torch.equal(out_k, out_p)})")
        del out_k, out_p, diff
    return worst


def k4_bound(args, max_mcus: int, bpm: int) -> dict:
    """K4's byte bound: its arguments read once, out [max_mcus, bpm, 64, S]
    i32 and err [S] written once."""
    lanes = args[0].shape[1]
    return bound(nbytes(*args) + max_mcus * bpm * 64 * lanes * 4 + lanes)


def check_k4_4k(plans, host_planes, geom, k3_coeffs, k3_batch, k3_ms,
                dev) -> tuple[float, dict]:
    """K4's batch tier over the 4K frames in one launch: no lane flagged,
    coefficients equal K3's and, as planes, the C++ decoder's. Times K4 at
    all frames and at one, beside K3 at the same frames. Returns (ms,
    bound) at all frames."""
    import torch

    from jpeg_tpu_torch.entropy import device_huffman as k3
    from jpeg_tpu_torch.entropy import device_kernel as k4
    from jpeg_tpu_torch.models.decoder import coefficient_planes_from_blocks

    got, err = k4.decode_coefficients_device4_batch(plans, device=dev,
                                                    to_host=False)
    n = err.numel()
    check(not bool(err.any()), f"K4 batch tier on {len(plans)} 4K frames "
          f"({n} lanes, one launch): no lane flagged")
    for i in range(len(plans)):
        r0, rows = k3_batch.images[i]
        if not torch.equal(got[i], k3_coeffs[r0 : r0 + rows]):
            raise CheckFailed(f"K4 coefficients of frame {i} differ from K3's")
        for c, plane in enumerate(coefficient_planes_from_blocks(got[i], geom)):
            if not np.array_equal(plane.cpu().numpy(), host_planes[i][c]):
                raise CheckFailed(f"K4 planes of frame {i}, component {c} "
                                  "differ from the C++ decoder")
    check(True, f"K4 on {len(plans)} 4K frames == K3 == C++ "
          "native_decode_planes, bit for bit")
    del got, err
    run_n, args_n, mm_n, s_n, _ = k4.kernel_runner_batch(plans, device=dev)
    run_1, args_1, _, s_1 = k4.kernel_runner(plans[0], device=dev)
    one = k3.prepare_lane_batch(plans[:1])
    lanes_1 = k3.lane_tensors(one, dev)
    ms_n = cuda_ms(lambda: run_n(*args_n), 5, 1, queued=True)
    ms_1 = cuda_ms(lambda: run_1(*args_1), 5, 1, queued=True)
    k3_1 = cuda_ms(lambda: k3.decode_lanes(lanes_1, s_1, one.total_rows), 5, 1,
                   queued=True)
    bnd_n = k4_bound(args_n, mm_n, plans[0].blocks_per_mcu)
    print(f"K4 {len(plans)}x4K ({s_n} lanes): {ms_n:.3f} ms, "
          f"{share(ms_n, bnd_n)}; 1x4K ({s_1} lanes): {ms_1:.3f} ms. K3 at the "
          f"same frames: {k3_ms:.3f} ms; {k3_1:.3f} ms (median, CUDA events)",
          flush=True)
    return ms_n, bnd_n


def single_frame_path(item: bytes, dev) -> tuple[int, int, float, float, dict]:
    """The single-frame device-entropy decode: K4 over the frame's restart
    segments, the coefficient planes, then K1 -> RGB, the coefficients
    staying on the card; held to ``decode_bytes(path="fast")`` (C++ entropy
    + K1). First K4 is held to its plain version on this frame's arguments.
    Returns (K4 launches, max abs err, kernel ms, plain ms, bound)."""
    import torch

    from jpeg_tpu_torch.entropy import device_kernel as k4
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.models.decoder import (
        PipelineGeometry,
        coefficient_planes_from_blocks,
        decode_bytes,
    )
    from jpeg_tpu_torch.ops import fused_plane as k1

    plan = parse_jpeg(item)
    run, args, max_mcus, n = k4.kernel_runner(plan, device=dev)
    consts = k4.kernel_constants(plan, dev)
    out_k, err_k = run(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out_p, err_p = k4.decode_words_plain(*args, *consts, max_mcus)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = int((out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max())
    check(not bool(err_k.any()) and torch.equal(err_k, err_p)
          and torch.equal(out_k, out_p),
          f"K4 vs plain on one 4K frame ({n} lanes, out {list(out_k.shape)}): "
          "no lane flagged, every element bit-identical")
    bnd = k4_bound(args, max_mcus, plan.blocks_per_mcu)
    del out_k, out_p
    ms = cuda_ms(lambda: run(*args), 5, 1, queued=True)
    print(f"K4 1x4K ({n} lanes): kernel {ms:.3f} ms, plain {plain_ms:.1f} ms "
          f"(CUDA events); {share(ms, bnd)}", flush=True)

    def decode(data):
        plan = parse_jpeg(data)
        coeffs, err = k4.decode_coefficients_device4(plan, device=dev,
                                                     to_host=False)
        planes = coefficient_planes_from_blocks(coeffs, PipelineGeometry.of(plan))
        return k1.decode_planes_fused(planes, plan, device=dev), err

    decode(item)  # warm-up
    k1.LAUNCHES.reset()
    k4.LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb, lane_err = decode(item)
    wall = time.perf_counter() - t0
    k1_launches, k4_launches = k1.LAUNCHES.value, k4.LAUNCHES.value
    check(k4_launches == 1 and k1_launches == 1,
          f"single-frame path went through the kernels: K4 launches "
          f"{k4_launches}, K1 launches {k1_launches}")
    check(not bool(lane_err.any()),
          f"single-frame path: none of {lane_err.numel()} lanes flagged")
    want = decode_bytes(item, path="fast", device="cuda")
    check(rgb.shape == (2160, 3840, 3) and np.array_equal(rgb, want),
          "single-frame device-entropy decode == decode_bytes(path='fast'), "
          "bit for bit")
    print(f"single-frame path, one 3840x2160 frame: {wall * 1e3:.3f} ms "
          "(host clock: parse, word columns + H2D, K4, relayout on the card, "
          "K1, D2H of RGB)", flush=True)
    return k4_launches, err, ms, plain_ms, bnd


def compat_path() -> None:
    """``decode_bytes``' default route, the compat decode (C++ entropy into
    zigzag blocks; on the card one fp32 product per component with the fused
    dequant + IDCT matrix, assembly, upsample, colour), on the first 4K
    fixture and the 512x384 colour and gray fixtures: within +-1 u8 of
    ``path="fast"`` on the card and of the same route on the CPU. Prints the
    count of differing values and the card route's host-clock time."""
    import torch

    from jpeg_tpu_torch import decode_bytes

    for name in (FRAMES_4K[0], SMALL_NO_RST, SMALL_RST[1]):
        data = read(name)
        decode_bytes(data, device="cuda")  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = decode_bytes(data, device="cuda")
        wall = time.perf_counter() - t0
        for label, want in (
                ("path='fast'", decode_bytes(data, path="fast", device="cuda")),
                ("device='cpu'", decode_bytes(data, device="cpu"))):
            diff = (np.abs(got.astype(np.int16) - want.astype(np.int16))
                    if got.shape == want.shape else np.full(1, 256))
            check(int(diff.max()) <= 1,
                  f"compat decode_bytes(device='cuda') of {name} vs {label}: "
                  f"within +-1 u8, {int((diff > 0).sum())} of {diff.size} "
                  "values differ")
        print(f"compat decode_bytes(device='cuda') of {name}: "
              f"{wall * 1e3:.3f} ms (host clock, bytes to RGB on the host)",
              flush=True)


def within_one(got: np.ndarray, want: np.ndarray) -> tuple[bool, int]:
    """(max |got - want| <= 1 with equal shapes, count of differing values)."""
    if got.shape != want.shape:
        return False, -1
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(diff.max()) <= 1, int((diff > 0).sum())


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock milliseconds of ``fn()`` (after one warm-up), the
    card synchronised around each call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def every_stream_path() -> tuple[int, int]:
    """The stream kinds beside baseline Huffman: progressive (SOF2), SOF9
    and SOF10 through K1 (``decode_bytes(path="fast")``, bit for bit with
    the CPU route), CMYK, YCCK and RGB-direct through the compat route
    (within +-1 u8 of the CPU and of ``path="fast"``, which sends them
    there); then the mixed corpus through the hybrid batched decoder and
    both ``CorpusDecoder`` routes. Returns the mixed corpus' K1 and K3
    launches."""
    import torch

    from jpeg_tpu_torch import (
        BatchedCorpusDecoder,
        CorpusDecoder,
        decode_bytes,
        parse_jpeg,
    )
    from jpeg_tpu_torch.entropy import device_huffman as k3
    from jpeg_tpu_torch.models.decoder import PipelineGeometry, host_planes
    from jpeg_tpu_torch.ops import fused_plane as k1

    fast, compat = {}, {}  # name -> decode_bytes on the card, per route
    for name in (PROG_4K, SOF9_4K, *K1_ROUTE_SMALL):
        data = read(name)
        before = k1.LAUNCHES.value
        fast[name] = decode_bytes(data, path="fast", device="cuda")
        launched = k1.LAUNCHES.value - before
        cpu = decode_bytes(data, path="fast", device="cpu")
        check(launched == 1 and np.array_equal(fast[name], cpu),
              f"{name}: decode_bytes(path='fast') through K1 ({launched} "
              f"launch) == device='cpu', bit for bit")
        compat[name] = decode_bytes(data, device="cuda")
        for label, want in (("device='cpu'", decode_bytes(data, device="cpu")),
                            ("path='fast'", fast[name])):
            ok, n = within_one(compat[name], want)
            check(ok, f"{name}: compat decode_bytes(device='cuda') vs {label}: "
                  f"within +-1 u8, {n} of {want.size} values differ")
    for name in COMPAT_ROUTE:
        data = read(name)
        compat[name] = decode_bytes(data, device="cuda")
        before = k1.LAUNCHES.value
        fast[name] = decode_bytes(data, path="fast", device="cuda")
        check(k1.LAUNCHES.value == before
              and np.array_equal(fast[name], compat[name]),
              f"{name}: path='fast' takes the compat route (no K1 launch)")
        ok, n = within_one(compat[name], decode_bytes(data, device="cpu"))
        check(ok, f"{name}: compat decode_bytes(device='cuda') vs "
              f"device='cpu': within +-1 u8, {n} of {compat[name].size} "
              "values differ")
    for name in (PROG_4K, SOF9_4K):
        plan = parse_jpeg(read(name))
        planes = [p.copy() for p in host_planes(plan)]
        entropy = host_ms(lambda: host_planes(plan))
        pixels = host_ms(lambda: k1.decode_planes_fused(planes, plan,
                                                        "truncate", "cuda"))
        print(f"{name}: host entropy {entropy:.3f} ms ({os.cpu_count()} "
              f"cores), H2D + K1 + D2H {pixels:.3f} ms (median of 3, host "
              "clock)", flush=True)
    # Nested pools: each corpus worker's progressive decode starts its own
    # scan threads (as in the JAX package). Eight progressive frames, host
    # route, one worker against one per core.
    prog8 = [read(PROG_4K)] * BATCH
    for workers in (1, os.cpu_count()):
        bd = BatchedCorpusDecoder(workers=workers, device="cuda")
        bd.decode_all(prog8)  # warm-up
        t0 = time.perf_counter()
        bd.decode_all(prog8)
        wall = time.perf_counter() - t0
        bd.close()
        print(f"{BATCH} 4K progressive frames, host route, {workers} "
              f"worker(s): {wall:.3f} s = {BATCH / wall:.2f} frames/s (host "
              "clock)", flush=True)

    # The mixed corpus: the 4K progressive and SOF9 frames, one of each
    # small image, and last (where the device thread claims) eight baseline
    # 4K frames with a restart per MCU row.
    names = ([PROG_4K] * MIXED_COPIES + [SOF9_4K] * MIXED_COPIES
             + K1_ROUTE_SMALL + COMPAT_ROUTE
             + [FRAMES_4K[i % 2] for i in range(BATCH)])
    items = [read(n) for n in names]
    for name in FRAMES_4K:
        fast[name] = decode_bytes(read(name), path="fast", device="cuda")
    k1_names = [n for n in names if n not in COMPAT_ROUTE]
    n_geoms = len({PipelineGeometry.of(parse_jpeg(read(n))) for n in k1_names})
    warm = BatchedCorpusDecoder(hybrid_device=True, device_batch=MIXED_BATCH,
                                device="cuda")
    warm.decode_all(items)
    warm.close()
    dec = BatchedCorpusDecoder(hybrid_device=True, device_batch=MIXED_BATCH,
                               device="cuda")
    k1.LAUNCHES.reset()
    k3.LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = dec.decode_all(items)
    wall = time.perf_counter() - t0
    k1_launches, k3_launches = k1.LAUNCHES.value, k3.LAUNCHES.value
    dec.close()
    check(all(r.ok for r in got),
          f"mixed corpus: all {len(items)} items decoded "
          f"({[r.error for r in got if not r.ok]})")
    check(all(np.array_equal(r.rgb, fast[n] if n in k1_names else compat[n])
              for r, n in zip(got, names)),
          "mixed corpus: each K1 item == decode_bytes(path='fast', "
          "device='cuda'), each compat item == decode_bytes(device='cuda')")
    check(dec.pixel_launches == n_geoms,
          f"mixed corpus: {dec.pixel_launches} K1 buckets == {n_geoms} K1 "
          "geometries (progressive and SOF9 4K frames share the baseline "
          "frames' bucket)")
    check(dec.device_frames > 0 and k1_launches > 0 and k3_launches > 0,
          f"mixed corpus went through the kernels: K1 launches {k1_launches}, "
          f"K3 launches {k3_launches}, device-decoded frames "
          f"{dec.device_frames}, frames handed back to the host "
          f"{dec.fallback_frames}")
    print(f"mixed corpus: {len(items)} items in {wall:.3f} s = "
          f"{len(items) / wall:.2f} items/s (host clock, not a claim)",
          flush=True)
    for path, want in (("fast", fast), ("compat", compat)):
        if path == "compat":
            for n in set(k1_names) - set(compat):
                compat[n] = decode_bytes(read(n), device="cuda")
        cd = CorpusDecoder(path=path, device="cuda")
        t0 = time.perf_counter()
        res = cd.decode_all(items)
        wall = time.perf_counter() - t0
        cd.close()
        check(all(r.ok and np.array_equal(r.rgb, want[n])
                  for r, n in zip(res, names)),
              f"CorpusDecoder(path='{path}'): every item == decode_bytes("
              f"path='{path}', device='cuda') ({len(items)} items, "
              f"{wall:.3f} s)")
    return k1_launches, k3_launches


def entropy_names(plans, dev) -> dict:
    """K3 under every device-entropy tier name of the JAX package, on the
    main path's claim (``plans``: BATCH 4K frames, a restart per MCU row,
    1,080 lanes): the v1 names (``device_decode``), v2 and v3
    (``device_decode2``), the v2 batch and ``window_runner_batch``, each
    with the K3 counter set to 0 just before it and read just after, each
    bit for bit with ``decode_coefficients_device5_batch`` on the card,
    whose frames equal the C++ decoder's blocks. Returns K3's launches per
    name."""
    import torch

    from jpeg_tpu_torch import runtime
    from jpeg_tpu_torch.entropy import device_decode as v1
    from jpeg_tpu_torch.entropy import device_decode2 as v2
    from jpeg_tpu_torch.entropy import device_huffman as k3
    from jpeg_tpu_torch.entropy import device_window as v5

    want, want_err = v5.decode_coefficients_device5_batch(plans, dev,
                                                          to_host=False)
    check(not bool(want_err.any()) and all(
        np.array_equal(w.cpu().numpy(), runtime.native_decode_coefficients(p))
        for w, p in zip(want, plans)),
          f"entropy names: decode_coefficients_device5_batch on {len(plans)} "
          f"4K frames ({want_err.numel()} lanes) == C++ "
          "native_decode_coefficients, bit for bit")
    lanes0 = len(plans[0].segments)

    def window(ps):
        run, args, meta = v5.window_runner_batch(ps, dev)
        check(meta[0] == max(s.mcu_count for p in ps for s in p.segments)
              and meta[1] == want_err.numel() and len(meta[2]) == len(ps)
              and int(meta[3].sum()) == 8 * sum(
                  s.byte_end - s.byte_start for p in ps for s in p.segments),
              "window_runner_batch meta: (max_mcus, S, lane_base, bitend)")
        coeffs, err = run(*args)
        b = k3.prepare_lane_batch(ps)
        return [coeffs[r0 : r0 + n] for r0, n in b.images], err

    names = {
        "device_decode.decode_coefficients_device":
            lambda: v1.decode_coefficients_device(plans[0], device=dev),
        "device_decode.decode_coefficients_device_batch":
            lambda: v1.decode_coefficients_device_batch(plans, device=dev),
        "device_decode2.decode_coefficients_device2":
            lambda: v2.decode_coefficients_device2(plans[0], device=dev),
        "device_decode2.decode_coefficients_device3":
            lambda: v2.decode_coefficients_device3(plans[0], device=dev),
        "device_decode2.decode_coefficients_device2_batch":
            lambda: v2.decode_coefficients_device2_batch(plans, device=dev),
        "device_window.window_runner_batch": lambda: window(plans),
    }
    launches = {}
    for name, call in names.items():
        k3.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coeffs, err = call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches[name] = k3.LAUNCHES.value
        if not isinstance(coeffs, list):
            coeffs = [coeffs]
        n = len(coeffs)
        same = (torch.equal(err, want_err[: lanes0 * n] if n == 1 else want_err)
                and all(torch.equal(c, w) for c, w in zip(coeffs, want)))
        check(launches[name] == 1 and same,
              f"{name}: K3 launched {launches[name]} time(s), {n} 4K "
              f"frame(s) == decode_coefficients_device5_batch bit for bit "
              f"({wall:.3f} ms host clock, tables and lanes prepared "
              "included)")
    return launches


def k7_lane_symbols(out, n_dec, bpm: int):
    """Huffman symbols each lane of K7 decoded in whole MCUs, counted from
    its coefficient rows: per block the DC code, one code per non-zero AC
    coefficient, a ZRL per 16 zeros before one, and EOB unless coefficient
    63 is non-zero. A lane's serial chain is one step a symbol."""
    import torch

    n_lanes, rows, _ = out.shape
    dev = out.device
    ac = out[..., 1:] != 0
    idx = torch.arange(1, 64, device=dev, dtype=torch.int16)
    at = torch.where(ac, idx, torch.zeros((), dtype=torch.int16, device=dev))
    last = at.amax(-1)
    prev = torch.cummax(at, -1).values
    prev = torch.cat([torch.zeros_like(prev[..., :1]), prev[..., :-1]], -1)
    zrl = torch.where(ac, (idx - prev - 1) // 16, 0).sum(-1)
    per_row = 1 + ac.sum(-1) + zrl + (last < 63).to(zrl.dtype)
    decoded = (torch.arange(rows, device=dev)[None, :]
               < (n_dec.to(torch.int64) * bpm)[:, None])
    return (per_row * decoded).sum(-1)


def speculative(dev, card: str) -> dict:
    """K7 and the speculative chunk-lane decode around it, on one 3840x2160
    q85 4:2:0 frame without restart markers written by the port's encoder:
    ``decode_coefficients_device_spec`` at 2,048 and 1,024 lanes (overlap
    24) and at 2,048 lanes with overlap 2 (gap recovery on the host), each
    with the K7 counter set to 0 just before it and read just after, each
    bit for bit with the C++ ``native_decode_coefficients``; the 4K
    restart-per-row fixture at 2,048 lanes (several segments merged); K7
    against its plain twin on every element of its four outputs, at 512x384
    (64 lanes, overlap 24 and 2) and once at 4K (2,048 lanes). Prints
    lanes, cap and gap MCUs, and the median times of K7 (CUDA events,
    queued, the zeroing of its outputs included), the control arrays' one
    device-to-host copy, the host merge, the relocate and the whole call
    (host clock; the overlap-2 call's merge and whole call timed once after
    a warm-up), beside ``native_decode_planes(speculative=True)`` and K3
    (one lane: the scan is one segment) on the same frame, K7's byte bound
    and its longest lane's symbols with their estimated serial time.
    Returns K7's record for the kernels line."""
    import torch

    from jpeg_tpu_torch import encode_rgb, runtime
    from jpeg_tpu_torch.entropy import device_huffman as k3
    from jpeg_tpu_torch.entropy import device_spec as k7
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.tools import bench_device_spec

    t0 = time.perf_counter()
    data = encode_rgb(synthetic_image(3840, 2160, seed=0), quality=QUALITY,
                      subsampling=(2, 2), restart_interval_mcus=0)
    plan = parse_jpeg(data)
    check(len(plan.segments) == 1,
          f"speculative: 4K frame encoded by the port, {len(data)} bytes, no "
          f"restart marker ({time.perf_counter() - t0:.1f} s host clock)")
    want = runtime.native_decode_coefficients(plan, reuse_buffer=False)
    n_comp, bpm, n_bytes = len(plan.components), plan.blocks_per_mcu, len(
        plan.scan_data)
    runs = {}
    for label, lanes, overlap in (("2048 lanes", 2048, 24),
                                  ("1024 lanes", 1024, 24),
                                  ("2048 lanes overlap 2", 2048, 2)):
        k7.LAUNCHES.reset()
        torch.cuda.synchronize()
        coeffs, stats = k7.decode_coefficients_device_spec(
            plan, lanes, overlap, device=dev)
        torch.cuda.synchronize()
        launches = k7.LAUNCHES.value
        check(launches == 1 and coeffs is not None
              and coeffs.device.type == "cuda"
              and np.array_equal(coeffs.cpu().numpy(), want)
              and (overlap > 2 or stats["gap_mcus"] > 0),
              f"speculative, {label}: K7 launched {launches} time(s), {stats}, "
              "== C++ native_decode_coefficients bit for bit"
              + (", gap recovery ran" if overlap == 2 else ""))
        # The gap-heavy call is host-bound at ~0.7 s: one timed rep there.
        # The whole call is timed by the ladder tool's own rung.
        reps = 3 if overlap > 2 else 1
        rung = bench_device_spec.run(plan, lanes, overlap, reps, dev)
        whole = rung["ms"]
        ls, ce, se, groups = k7._chunk_lanes(plan, lanes)
        cap = k7.spec_cap(groups, overlap)
        # Both table sets: the 2,048-lane tensors also feed the twin below.
        t = k7.spec_tensors(plan, ls, ce, se, dev, tables="both")
        ms = cuda_ms(lambda: k7.spec_lanes(t, n_bytes, cap, overlap, n_comp),
                     5, 1, queued=True)
        out, *ctrl = k7.spec_lanes(t, n_bytes, cap, overlap, n_comp)
        d2h = host_ms(lambda: k7.control_to_host(*ctrl))
        host = k7.control_to_host(*ctrl)
        merge = host_ms(lambda: k7.merge_lanes(
            plan, groups, *host, cap, {"merged": 0, "failed": 0, "gap_mcus": 0}),
            reps)
        merged = k7.merge_lanes(plan, groups, *host, cap,
                                {"merged": 0, "failed": 0, "gap_mcus": 0})
        reloc = host_ms(lambda: k7.relocate(plan, out, *merged))
        zero = cuda_ms(lambda: torch.zeros_like(out), 5, 1, queued=True)
        symbols = k7_lane_symbols(out, ctrl[2], bpm)
        n_bytes_moved = nbytes(*(t[k] for k in K7_INPUTS), out, *ctrl)
        bnd = bound(n_bytes_moved)
        serial = (float(symbols.max()) * K3_CYCLES_PER_STEP_EST / SM_CLOCK_HZ
                  * 1e3)
        runs[label] = dict(cap=cap, stats=stats, launches=launches, ms=ms,
                           bnd=bnd, t=t)
        print(f"speculative, {label} ({card}): lanes {stats['lanes']}, cap "
              f"{cap}, gap_mcus {stats['gap_mcus']}, merged {stats['merged']}; "
              f"median ms: K7 {ms:.4f} (its outputs' zeroing alone {zero:.4f}; "
              f"CUDA events, queued), control-array D2H {d2h:.3f}, host merge "
              f"{merge:.3f}, relocate {reloc:.3f}, whole call {whole:.3f} (host "
              f"clock); K7 {share(ms, bnd)} ({n_bytes_moved / 1e6:.1f} MB); "
              f"(the ladder's rung: K7 alone {rung['k7_ms']:.4f}, not "
              f"queued); longest lane {int(symbols.max())} symbols (mean "
              f"{float(symbols.float().mean()):.0f}), serial estimate, not a "
              f"bound, {serial:.4f} ms at K3's measured ~"
              f"{K3_CYCLES_PER_STEP_EST} cycles a step, {SM_CLOCK_HZ / 1e9:.2f} GHz",
              flush=True)
        del out, ctrl, coeffs
    # The restart-per-row fixture: chunk lanes inside each of its segments.
    rst = parse_jpeg(read(FRAMES_4K[0]))
    k7.LAUNCHES.reset()
    coeffs, stats = k7.decode_coefficients_device_spec(rst, 2048, device=dev)
    torch.cuda.synchronize()
    check(k7.LAUNCHES.value == 1 and coeffs is not None and stats["merged"] > 1
          and np.array_equal(coeffs.cpu().numpy(),
                             runtime.native_decode_coefficients(rst)),
          f"speculative, restart-per-row 4K fixture: {stats}, == C++ "
          "native_decode_coefficients bit for bit")
    del coeffs
    # K7 against its plain twin: 512x384 (64 lanes), then once at 4K.
    small = parse_jpeg(read(SMALL_NO_RST))
    for overlap in (24, 2):
        ls, ce, se, groups = k7._chunk_lanes(small, 64)
        cap = k7.spec_cap(groups, overlap)
        t = k7.spec_tensors(small, ls, ce, se, dev, tables="both")
        args = (t, len(small.scan_data), cap, overlap, len(small.components))
        got, want_p = k7.spec_lanes(*args), k7.spec_lanes_plain(*args)
        check(all(torch.equal(g, w) for g, w in zip(got, want_p)),
              f"K7 vs plain, 512x384, 64 lanes, overlap {overlap}: out, "
              "mcu_bits, dc_cum and n_dec equal in every element")
    main = runs["2048 lanes"]
    args = (main["t"], n_bytes, main["cap"], 24, n_comp)
    got = k7.spec_lanes(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_p = k7.spec_lanes_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = [int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            for g, w in zip(got, want_p)]
    check(max(errs) == 0,
          f"K7 vs plain, 4K, 2048 lanes: every element of the four outputs "
          f"equal (plain {plain_ms:.1f} ms, host clock, {card})")
    del got, want_p
    # For comparison: the host's speculative decode, and K3 with one lane.
    planes_ms = host_ms(lambda: runtime.native_decode_planes(plan,
                                                             speculative=True))
    batch = k3.prepare_lane_batch([plan])
    lanes3 = k3.lane_tensors(batch, dev)
    k3_ms = cuda_ms(lambda: k3.decode_lanes(lanes3, 1, batch.total_rows), 3, 1,
                    queued=True)
    print(f"speculative, same frame ({card}): C++ native_decode_planes("
          f"speculative=True) {planes_ms:.3f} ms ({os.cpu_count()} threads, "
          f"host clock); K3, one lane (the scan is one segment), "
          f"{k3_ms:.3f} ms (CUDA events)", flush=True)
    return {"name": "K7 huffman_spec", "route": "cuda",
            "source": "jpeg_tpu_torch/csrc/huffman_spec.cu",
            "replaces": "jpeg_tpu/entropy/device_spec.py:83",
            "launches": main["launches"], "max_abs_err": max(errs),
            "ms": main["ms"], "plain_ms": plain_ms, **main["bnd"],
            "library_ms": None,
            "lanes": main["stats"]["lanes"], "cap": main["cap"],
            "launches_by_call": {k: r["launches"] for k, r in runs.items()},
            "ms_by_call": {k: r["ms"] for k, r in runs.items()},
            "gap_mcus_by_call": {k: r["stats"]["gap_mcus"]
                                 for k, r in runs.items()}}


def stream_blocks(comp_blocks_zz, geom) -> np.ndarray:
    """An encoder's per-component quantized zigzag blocks [rows, cols, 64]
    -> [total_blocks, 64] in MCU stream order (the decoder's layout)."""
    my, mx = geom.mcus_y, geom.mcus_x
    per = [b.reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4)
           .reshape(my * mx, v * h, 64)
           for b, (h, v) in zip(comp_blocks_zz, geom.sampling)]
    return np.concatenate(per, axis=1).reshape(-1, 64)


def twelve_bit_image(width: int, height: int, seed: int) -> np.ndarray:
    """A seeded 12-bit RGB image: ``synthetic_image`` << 4 with its low
    four bits seeded too."""
    rng = np.random.default_rng(seed)
    img = synthetic_image(width, height, seed).astype(np.uint16) << 4
    return img | rng.integers(0, 16, img.shape).astype(np.uint16)


def formats(dev, card: str) -> dict:
    """The rest of the format matrix on the card: 12-bit decode through the
    compat route (``decode_bytes``, ``decode_file``, ``decode_batch``, the
    corpus decoders' inline route) with u16 out, within +-1 of the CPU run;
    lossless (SOF3): ``reconstruct_device`` at 4K on seeded differences,
    equal to the image and to the CPU run, and ``decode_bytes`` of 512x384
    streams equal to the CPU run, to ``native_decode_lossless``, to
    ``reconstruct`` and to the source; the new encoders (host, as in the JAX
    package), their bytes equal on their C++ and Python routes and each
    stream decoding back to its own quantized coefficients. Prints the
    lossless frames' routes and the host-clock times beside ``card``."""
    import dataclasses
    import tempfile

    import torch

    from jpeg_tpu_torch import (
        BatchedCorpusDecoder,
        CorpusDecoder,
        decode_batch,
        decode_bytes,
        decode_file,
        encode_cmyk,
        encode_rgb,
        encode_rgb_progressive,
        parse_jpeg,
        runtime,
    )
    from jpeg_tpu_torch.entropy import lossless
    from jpeg_tpu_torch.entropy import progressive_encode as pe
    from jpeg_tpu_torch.models import decoder as dec
    from jpeg_tpu_torch.models.encoder import _forward_transform

    times = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        times[label] = (time.perf_counter() - t0) * 1e3
        return out

    # The narrowing the 12-bit and lossless routes end with, on the card.
    x = torch.arange(-3, 4100, 7, dtype=torch.int32, device=dev)
    u = x.clamp(0, 4095).to(torch.uint16)
    check(u.dtype == torch.uint16 and np.array_equal(
        u.cpu().numpy(), np.clip(x.cpu().numpy(), 0, 4095).astype(np.uint16)),
          ".to(torch.uint16) on the card == numpy's narrowing")

    # 12-bit streams: 4K SOF1 (4:2:0), SOF9 and SOF2 (C++ encoders), SOF10
    # at 512x384 (the Python QM coder, as in the JAX package).
    img4k = twelve_bit_image(*FORMATS_4K, seed=20)
    kw = dict(quality=QUALITY, subsampling=(2, 2))
    streams = {
        "SOF1 4K": timed("encode_rgb(precision=12) 4K",
                         lambda: encode_rgb(img4k, precision=12, **kw)),
        "SOF9 4K": timed("encode_rgb(precision=12, arithmetic=True) 4K",
                         lambda: encode_rgb(img4k, precision=12,
                                            arithmetic=True, **kw)),
        "SOF2 4K": timed("encode_rgb_progressive(precision=12) 4K",
                         lambda: encode_rgb_progressive(img4k, precision=12,
                                                        **kw)),
    }
    img512 = twelve_bit_image(*FORMATS_SMALL, seed=21)
    streams["SOF10 512x384"] = timed(
        "encode_rgb_progressive(precision=12, arithmetic=True) 512x384",
        lambda: encode_rgb_progressive(img512, precision=12, arithmetic=True,
                                       **kw))
    img8 = synthetic_image(*FORMATS_4K, seed=22)
    prog8 = timed("encode_rgb_progressive 4K",
                  lambda: encode_rgb_progressive(img8, **kw))
    # Each stream decodes back to the encoder's own quantized coefficients.
    blocks12 = _forward_transform(img4k, QUALITY, (2, 2), False, 12)[0]
    blocks512 = _forward_transform(img512, QUALITY, (2, 2), False, 12)[0]
    blocks8 = _forward_transform(img8, QUALITY, (2, 2), False, 8)[0]
    for name, data, blocks in [
            *((n, streams[n], blocks12) for n in ("SOF1 4K", "SOF9 4K",
                                                  "SOF2 4K")),
            ("SOF10 512x384", streams["SOF10 512x384"], blocks512),
            ("8-bit SOF2 4K", prog8, blocks8)]:
        plan = parse_jpeg(data)
        got = dec.decode_coefficients_host(plan)
        check(np.array_equal(got, stream_blocks(blocks,
                                                dec.PipelineGeometry.of(plan))),
              f"{name} ({len(data)} bytes, precision {plan.precision}): "
              "decodes back to the encoder's quantized coefficients")
    # Their C++ and Python routes write the same bytes (at 512x384).
    small8 = synthetic_image(*FORMATS_SMALL, seed=23)
    b12 = _forward_transform(img512, QUALITY, (2, 2), False, 12)
    check(encode_rgb(img512, precision=12, **kw)
          == encode_rgb(img512, precision=12, engine="python", **kw)
          and encode_rgb(small8, arithmetic=True, restart_interval_mcus=4, **kw)
          == encode_rgb(small8, arithmetic=True, restart_interval_mcus=4,
                        engine="python", **kw),
          "encode_rgb(precision=12) and encode_rgb(arithmetic=True): C++ "
          "route == Python route, byte for byte (512x384)")
    nat = runtime.native_encode_progressive_scans(
        b12[0], b12[1], b12[5], b12[6], *FORMATS_SMALL, restart_interval=5)
    py = pe.encode_progressive_scans(b12[0], b12[1], b12[5], b12[6],
                                     *FORMATS_SMALL, restart_interval=5)
    check([s["data"] for s in nat] == [s["data"] for s in py],
          f"native_encode_progressive_scans == encode_progressive_scans, "
          f"{len(nat)} scans byte for byte (12-bit 512x384, restarts)")
    cmyk = np.random.default_rng(24).integers(0, 256, (192, 256, 4), np.uint8)
    for ycck in (False, True):
        data = encode_cmyk(cmyk, arithmetic=True, ycck=ycck,
                           restart_interval_mcus=6)
        plan = parse_jpeg(data)
        got = dec.decode_coefficients_host(plan).copy()
        q = parse_jpeg(encode_cmyk(cmyk, ycck=ycck))
        check(plan.arith_code and np.array_equal(
            got, dec.decode_coefficients_host(q)),
              f"encode_cmyk(arithmetic=True, ycck={ycck}): SOF9 decoding to "
              "the coefficients of the Huffman stream (the same transform)")

    # 12-bit decode on the card against the CPU run.
    for name, data in streams.items():
        plan = parse_jpeg(data)
        got = decode_bytes(data, device=dev)
        want = decode_bytes(data, device="cpu")
        ok, n = within_one(got, want)
        check(ok and got.dtype == np.uint16 and got.max() > 255,
              f"12-bit {name}: decode_bytes(device='cuda') {got.shape} u16 "
              f"within +-1 of device='cpu', {n} of {got.size} values differ")
        fast = decode_bytes(data, path="fast", device=dev)
        check(np.array_equal(fast, got),
              f"12-bit {name}: path='fast' takes the compat route")
    data = streams["SOF1 4K"]
    plan = parse_jpeg(data)
    entropy = host_ms(lambda: dec.decode_coefficients_host(plan))
    coeffs = dec.decode_coefficients_host(plan).copy()
    dense = host_ms(lambda: dec.decode_plan(plan, coefficients=coeffs,
                                            device=dev))
    times["12-bit 4K decode: entropy (C++)"] = entropy
    times["12-bit 4K decode: dense stage (H2D, matmul, colour, D2H)"] = dense
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "twelve.jpg")
        with open(path, "wb") as f:
            f.write(data)
        check(np.array_equal(decode_file(path, device=dev),
                             decode_bytes(data, device=dev)),
              "12-bit SOF1 4K: decode_file == decode_bytes on the card")
    second = parse_jpeg(encode_rgb(twelve_bit_image(*FORMATS_4K, seed=25),
                                   precision=12, **kw))
    geom = dec.PipelineGeometry.of(plan)
    check(dec.PipelineGeometry.of(second) == geom and geom.precision == 12,
          "two 4K 12-bit frames share one geometry")
    batch = decode_batch(
        np.stack([coeffs, dec.decode_coefficients_host(second).copy()]),
        np.stack([dec.plan_matrices(plan), dec.plan_matrices(second)]),
        geom, device=dev).cpu().numpy()
    ok, n = within_one(batch[0], decode_bytes(data, device=dev))
    check(ok and batch.dtype == np.uint16,
          f"decode_batch of two 4K 12-bit frames: u16, frame 0 within +-1 "
          f"of decode_bytes, {n} values differ")
    del batch, coeffs

    # Lossless: reconstruct_device at 4K on seeded differences (predictors
    # 1 and 2), then 512x384 streams end to end.
    routes = {"C++ differences, cumsum on the card": 0,
              "C++ jt_decode_lossless": 0}
    src = synthetic_image(*FORMATS_4K, seed=26)
    for predictor in (1, 2):
        meta = dataclasses.replace(
            parse_jpeg(lossless.encode_lossless(src[:16, :16],
                                                predictor=predictor)),
            width=FORMATS_4K[0], height=FORMATS_4K[1])
        diffs = lossless.prediction_differences(
            src.astype(np.int32), predictor, 128).reshape(src.shape)
        got = lossless.reconstruct_device(meta, diffs, dev)
        check(got.dtype == torch.uint16 and np.array_equal(
            got.cpu().numpy(), src) and np.array_equal(
            got.cpu().numpy(),
            lossless.reconstruct_device(meta, diffs, "cpu").numpy()),
              f"reconstruct_device, predictor {predictor}, 4K RGB on the "
              "card: u16 == the image == the CPU run, bit for bit")
        times[f"reconstruct_device 4K predictor {predictor} (H2D, cumsum, "
              "D2H)"] = host_ms(lambda: lossless.reconstruct_device(
                  meta, diffs, dev).cpu())
    small = synthetic_image(*FORMATS_SMALL, seed=27)
    for predictor, ri in ((1, 0), (4, FORMATS_SMALL[0] * 8)):
        data = lossless.encode_lossless(small, predictor=predictor,
                                        restart_interval=ri)
        plan = parse_jpeg(data)
        route = ("C++ differences, cumsum on the card"
                 if lossless.cumsum_takes(plan) else "C++ jt_decode_lossless")
        routes[route] += 1
        t0 = time.perf_counter()
        got = decode_bytes(data, device=dev)
        times[f"lossless 512x384 RGB predictor {predictor}, restart "
              f"interval {ri}: decode_bytes end to end ({route})"] = (
                  time.perf_counter() - t0) * 1e3
        label = (f"lossless 512x384 RGB predictor {predictor}, restart "
                 f"interval {ri}")
        times[f"{label}: decode_lossless(plan), the default device "
              f"({route})"] = host_ms(lambda: lossless.decode_lossless(plan))
        times[f"{label}: decode_lossless(plan, device=None), the JAX "
              "default's host route (C++ jt_decode_lossless)"] = host_ms(
                  lambda: lossless.decode_lossless(plan, device=None))
        times[f"{label}: native_decode_lossless_diffs (C++)"] = host_ms(
            lambda: runtime.native_decode_lossless_diffs(plan))
        t0 = time.perf_counter()
        diffs = lossless.decode_diffs(plan)
        times[f"{label}: decode_diffs (pure Python, one call)"] = (
            time.perf_counter() - t0) * 1e3
        oracle = lossless.reconstruct(plan, diffs)
        check(np.array_equal(got, decode_bytes(data, device="cpu"))
              and np.array_equal(got, lossless.decode_lossless(plan))
              and np.array_equal(got, runtime.native_decode_lossless(plan))
              and np.array_equal(runtime.native_decode_lossless_diffs(plan),
                                 diffs & 0xFFFF)
              and np.array_equal(got, oracle) and np.array_equal(got, small),
              f"lossless predictor {predictor}, restart interval {ri} "
              f"({route}): decode_bytes on the card == device='cpu' == "
              "decode_lossless(plan) == native_decode_lossless == "
              "reconstruct == the source; C++ differences == decode_diffs")
    auto = lossless.encode_lossless(small, predictor="auto")
    check(np.array_equal(decode_bytes(auto, device=dev), small),
          f"encode_lossless(predictor='auto') (predictor "
          f"{parse_jpeg(auto).predictor}) round-trips to the input")

    # The corpus decoders' inline route: 12-bit and lossless items beside
    # 8-bit ones, each equal to its decode_bytes on the card.
    tiny = synthetic_image(128, 96, seed=28)
    items = [streams["SOF10 512x384"],
             encode_rgb(img512, precision=12, **kw),
             encode_rgb(img512, precision=12, arithmetic=True, **kw),
             lossless.encode_lossless(tiny, predictor=2),
             lossless.encode_lossless(tiny, predictor=6, restart_interval=50),
             read(SMALL_RST[0]), read(SMALL_RST[1]), read(SMALL_NO_RST)]
    compat = [decode_bytes(d, device=dev) for d in items]
    fast = [decode_bytes(d, path="fast", device=dev) for d in items]
    for label, decoder, want in [
            ("BatchedCorpusDecoder", BatchedCorpusDecoder(device=dev), fast),
            ("CorpusDecoder(path='compat')", CorpusDecoder(device=dev),
             compat),
            ("CorpusDecoder(path='fast')",
             CorpusDecoder(path="fast", device=dev), fast)]:
        res = decoder.decode_all(items)
        decoder.close()
        check(all(r.ok and r.rgb.dtype == w.dtype and np.array_equal(r.rgb, w)
                  for r, w in zip(res, want)),
              f"{label}: 12-bit and lossless items decoded inline, every item "
              "== its decode_bytes on the card")
    print(f"lossless frames by route: {routes}", flush=True)
    for label, ms in times.items():
        print(f"formats: {label}: {ms:.3f} ms (host clock; {card})",
              flush=True)
    return {"routes": routes, "times_ms": times}


def idct_roofline(dev) -> tuple[dict, dict]:
    """K5 and K6 on ``bench_idct_roofline``'s [4096, 3840] int16 plane
    (seed 0, values in [-512, 512), quant table 1..64): each equals its plain
    version bit for bit, K5 equals K6 by value, both sit within IDCT_REL_TOL
    of a float64 reference. Each is timed with 20 launches queued in a row
    and, one launch at a time, after an L2 flush. Beside them the closest
    library route is timed, which the port never calls: a cast to fp32,
    cuDNN's convolution with an 8x8, stride-8 kernel whose 64 filters fold
    the dequantisation into the IDCT basis, and ``pixel_shuffle(8)`` (two
    calls after the cast; TF32 off). Returns the measured fields of the K5
    and K6 records."""
    import torch

    from jpeg_tpu_torch.ops import idct_only as k56
    from jpeg_tpu_torch.ops.idct import dct_basis_1d

    rows, cols = IDCT_SHAPE
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-512, 512, (rows, cols))
                         .astype(np.int16)).to(dev)
    qpat = torch.from_numpy(k56.quant_pattern(np.arange(1, 65), 128, 256)).to(dev)
    k5 = k56.idct_only_kernel(rows, cols)
    k6 = k56.idct_only_kernel_roll(rows, cols)
    k5(x, qpat)  # warm-up: load, constant memory
    k6(x, qpat)
    torch.cuda.synchronize()
    k56.LAUNCHES.reset()
    k56.LAUNCHES_ROLL.reset()
    outs = {"K5": k5(x, qpat), "K6": k6(x, qpat)}
    torch.cuda.synchronize()
    launches = {"K5": k56.LAUNCHES.value, "K6": k56.LAUNCHES_ROLL.value}
    check(launches == {"K5": 1, "K6": 1},
          f"roofline path went through the kernels: launches {launches}")

    a = torch.tensor(dct_basis_1d(), dtype=torch.float64, device=dev)
    f = (x.double().view(rows // 128, 128, cols // 256, 256)
         * qpat.double().view(1, 128, 1, 256)).reshape(rows // 8, 8, cols // 8, 8)
    ref = torch.einsum("vy,bvcu,ux->bycx", a, f, a).reshape(rows, cols)
    bar = IDCT_REL_TOL * float(ref.abs().max())
    del f
    runs = {"K5": (k5, k56.idct_only_plain), "K6": (k6, k56.idct_only_roll_plain)}
    errs = {}
    for name, (_, plain) in runs.items():
        out = outs[name]
        want = plain(x, qpat)
        errs[name] = float((out - want).abs().max())
        check(same_bits(out, want), f"{name} vs plain at [{rows}, {cols}]: "
              f"bit for bit (max abs err {errs[name]})")
        ref_err = float((out.double() - ref).abs().max())
        check(bool(torch.isfinite(out).all()) and ref_err <= bar,
              f"{name} vs float64 reference: max abs err {ref_err:.3e} <= "
              f"{IDCT_REL_TOL} x max |out| = {bar:.3e}")
    check(torch.equal(outs["K5"], outs["K6"]), "K5 == K6 by value")
    fn = torch.nn.functional
    w = torch.einsum("vy,ux,vu->yxvu", a, a, qpat[:8, :8].double())
    w = w.reshape(64, 1, 8, 8).float()

    def library():
        y = fn.conv2d(x.float().view(1, 1, rows, cols), w, stride=8)
        return fn.pixel_shuffle(y, 8).view(rows, cols)

    lib_err = float((library().double() - ref).abs().max())
    lib_ms = cuda_ms(library, 5, 3, inner=20, queued=True)
    print(f"library route (cast + cuDNN conv2d + pixel_shuffle) [{rows}, "
          f"{cols}]: {lib_ms:.4f} ms (median, CUDA events, 20 queued in a row); max "
          f"abs err vs float64 {lib_err:.3e}", flush=True)
    del ref, outs, want, out
    records, blocks = [], rows * cols // 64
    bnd = bound(nbytes(x, qpat) + rows * cols * 4, rows * cols * OPS_PER_BLOCK / 64)
    for name, (run, plain) in runs.items():
        plain_ms = cuda_ms(lambda: plain(x, qpat), 3, 1)
        ms = cuda_ms(lambda: run(x, qpat), 10, 3, inner=20, queued=True)
        cold = cuda_ms_flushed(lambda: run(x, qpat), 20)
        print(f"{name} [{rows}, {cols}]: kernel {ms:.4f} ms = "
              f"{blocks / (ms / 1e3):.4e} blocks/s (20 launches queued in a "
              f"row), {cold:.4f} ms a launch after an L2 flush = "
              f"{blocks / (cold / 1e3):.4e} blocks/s; plain {plain_ms:.3f} ms; "
              f"{share(ms, bnd)}; flushed {bnd['bound_ms'] / cold:.4f} of it "
              "(medians, CUDA events)", flush=True)
        records.append({"launches": launches[name], "max_abs_err": errs[name],
                        "ms": ms, "ms_l2_flushed": cold, "plain_ms": plain_ms,
                        **bnd, "library_ms": lib_ms})
    return records[0], records[1]


def k2_inputs(imgs, dev, **kw):
    """(geometry, rgb [B, n_comp, H_pad, W_pad] u8, reciprocal tables
    [B, n_comp, 64] f32 on ``dev``) of K2 for a batch of equal-sized images."""
    import torch

    from jpeg_tpu_torch.models.encoder import device_inputs

    parts = [device_inputs(im, QUALITY, **kw) for im in imgs]
    return (parts[0][0],
            torch.from_numpy(np.stack([p[1] for p in parts])).to(dev),
            torch.from_numpy(np.stack([p[2] for p in parts])).to(dev))


def k2_bound(rgb, iq, geom) -> dict:
    """K2's bound from its shapes: rgb and tables read, int16 planes written;
    two 1-D passes and the quantiser per block, 15 colour operations a pixel."""
    from jpeg_tpu_torch.ops.fused_plane import padded_plane_shapes

    coeffs = rgb.shape[0] * sum(r * c for r, c in padded_plane_shapes(geom))
    return bound(nbytes(rgb, iq) + 2 * coeffs,
                 coeffs / 64 * OPS_PER_BLOCK + 15 * rgb[:, 0].numel())


def check_huffman_encode(frames, dev) -> dict:
    """K8, the encoder's Huffman pack, against the C++ packer on K2's
    planes: ``pack_planes_device`` (K8 and the container) equal to
    ``pack_planes`` (the planes downloaded, the C++ pack) for two 4K 4:2:0
    frames with a restart every MCU row and with none, and for 4:2:2, 4:4:4
    and gray at 512x384 with a restart every 7 MCUs (segments that end
    mid-row). Then K8 at the 4K shape: its six kernels queued (CUDA
    events), the whole pack with its two reads and the copy out (host
    clock), and its plain twin on the host's CPU. Returns the measured
    fields of K8's record."""
    import torch

    from jpeg_tpu_torch.models import encoder
    from jpeg_tpu_torch.ops import huffman_encode as k8
    from jpeg_tpu_torch.parallel.batch import encode_batch_device

    def k2_planes(img, **kw):
        geom, planar, iq, quant_zz = encoder.device_inputs(img, QUALITY, **kw)
        planes = encode_batch_device(planar[None], iq[None], geom, device=dev)
        return geom, [p[0] for p in planes], quant_zz

    def compare(label, geom, planes, quant_zz, restart) -> int:
        got = encoder.pack_planes_device(planes, geom, quant_zz, restart)
        torch.cuda.synchronize()
        want = encoder.pack_planes([p.cpu().numpy() for p in planes], geom,
                                   quant_zz, restart)
        check(got == want, f"K8 vs the C++ packer, {label}: {len(got)} and "
              f"{len(want)} bytes, equal")
        return len(got)

    before, cases = k8.LAUNCHES.value, 0
    for n, frame in enumerate(frames[:2]):
        geom, planes, quant_zz = k2_planes(frame, subsampling=(2, 2))
        for restart in (RESTART_4K, 0):
            size = compare(f"4K frame {n} 4:2:0, restart {restart}", geom,
                           planes, quant_zz, restart)
            cases += 1
    img = synthetic_image(512, 384, seed=3)
    for label, kw in (("4:2:2", dict(subsampling=(2, 1))),
                      ("4:4:4", dict(subsampling=(1, 1))),
                      ("gray", dict(grayscale=True))):
        src = img[..., 0] if kw.get("grayscale") else img
        compare(f"512x384 {label}, restart 7", *k2_planes(src, **kw), 7)
        cases += 1
    check(k8.LAUNCHES.value == before + cases,
          f"K8 launched once a pack: {k8.LAUNCHES.value - before} for {cases}")

    geom, planes, _ = k2_planes(frames[0], subsampling=(2, 2))
    _, _, tables = encoder._annex_k_pack(False, planes[0].device)
    scan = k8.huffman_encode_cuda(planes, geom, RESTART_4K, tables)
    ms = cuda_ms(lambda: k8.enqueue(planes, geom, RESTART_4K, tables), 10, 2,
                 inner=10, queued=True)
    ms_norst = cuda_ms(lambda: k8.enqueue(planes, geom, 0, tables), 10, 2,
                       inner=10, queued=True)
    wall = host_ms(lambda: k8.huffman_encode_cuda(planes, geom, RESTART_4K,
                                                  tables), reps=10)
    cpu_planes = [p.cpu() for p in planes]
    t0 = time.perf_counter()
    plain = k8.huffman_encode_plain(cpu_planes, geom, RESTART_4K,
                                    tables.cpu())
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(plain == scan, "K8 vs its plain twin, 4K frame 0: equal bytes")
    blocks = geom.mcus_x * geom.mcus_y * geom.blocks_per_mcu
    bnd = bound(2 * 128 * blocks + len(scan))  # the blocks read twice
    print(f"K8 1x{geom.width}x{geom.height} 4:2:0 ({blocks} blocks, "
          f"{len(scan)} scan bytes): kernels {ms:.4f} ms (restart per MCU "
          f"row), {ms_norst:.4f} ms (none), {share(ms, bnd)} (median, CUDA "
          f"events, packs queued in a row); whole pack with its reads "
          f"{wall:.3f} ms (host clock); plain twin {plain_ms:.1f} ms (the "
          f"host's CPU); last 4K stream {size} bytes", flush=True)
    return {"ms": ms, "ms_no_restarts": ms_norst, "wall_ms": wall,
            "plain_ms": plain_ms, "plain_on": "host CPU", **bnd,
            "frames": 1, "scan_bytes": len(scan), "compared": cases}


def check_k2(frames, dev) -> dict:
    """K2 against its plain version: every sampling it takes (the seven K1
    is held on, two seeded 520x200 images each), a 512x384 gray image, a
    512x384 4:4:4 image, the 8-frame 4K 4:2:0 batch (one launch for all, as
    ``encode_batch_device`` takes it) and its first frame alone (the shape
    ``encode_rgb_device`` launches). Returns the measured fields of K2's
    record: times and bounds at the 8-frame batch and at one frame."""
    import torch

    from jpeg_tpu_torch.models.decoder import PipelineGeometry
    from jpeg_tpu_torch.ops import fused_encode as k2
    from jpeg_tpu_torch.ops.fused_plane import padded_size

    def compare(label, geom, rgb, iq) -> int:
        got = k2.fused_plane_encode(rgb, iq, geom)
        want = k2.fused_plane_encode_plain(rgb, iq, geom)
        err = max(int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
                  for g, w in zip(got, want))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"K2 vs plain, {label}: every plane identical (max abs err {err})")
        return err

    err = 0
    for name, sub in K1_SAMPLINGS.items():
        imgs = [synthetic_image(520, 200, seed=seed) for seed in (5, 6)]
        if sub is None:
            args = k2_inputs([im[..., 0] for im in imgs], dev, grayscale=True)
        else:
            args = k2_inputs(imgs, dev, subsampling=sub)
        err = max(err, compare(f"{name} 2x520x200", *args))
    # A geometry off the usual ones (luma at half height, Cb and Cr unlike
    # each other), which takes K2's general kernel.
    odd = PipelineGeometry(width=520, height=200, mcus_x=33, mcus_y=13,
                           h_max=2, v_max=2, sampling=((2, 1), (1, 2), (1, 1)))
    rng = np.random.default_rng(8)
    err = max(err, compare(
        "2x520x200 sampling (2,1) (1,2) (1,1)", odd,
        torch.from_numpy(rng.integers(0, 256, (2, 3, *padded_size(odd)),
                                      dtype=np.uint8)).to(dev),
        torch.from_numpy((1.0 / rng.integers(1, 64, (2, 3, 64)))
                         .astype(np.float32)).to(dev)))
    gray = synthetic_image(512, 384, seed=4)[..., 0]
    err = max(err, compare("512x384 gray", *k2_inputs([gray], dev,
                                                      grayscale=True)))
    err = max(err, compare("512x384 4:4:4", *k2_inputs(
        [synthetic_image(512, 384, seed=2)], dev, subsampling=(1, 1))))
    geom, rgb, iq = k2_inputs(frames, dev, subsampling=(2, 2))
    size = f"{geom.width}x{geom.height}"
    err = max(err, compare(f"{len(frames)}x{size} 4:2:0", geom, rgb, iq))
    err = max(err, compare(f"1x{size} 4:2:0", geom, rgb[:1], iq[:1]))
    ms = cuda_ms(lambda: k2.fused_plane_encode(rgb, iq, geom), 10, 2,
                 inner=10, queued=True)
    bnd = k2_bound(rgb, iq, geom)
    plain_ms = cuda_ms(lambda: k2.fused_plane_encode_plain(rgb, iq, geom), 3, 1)
    ms1 = cuda_ms(lambda: k2.fused_plane_encode(rgb[:1], iq[:1], geom), 10, 2,
                  inner=20, queued=True)
    bnd1 = k2_bound(rgb[:1], iq[:1], geom)
    plain1 = cuda_ms(lambda: k2.fused_plane_encode_plain(rgb[:1], iq[:1], geom),
                     3, 1)
    print(f"K2 {len(frames)}x{size} 4:2:0: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, {share(ms, bnd)}; 1x{size}: kernel {ms1:.4f} "
          f"ms, plain {plain1:.3f} ms, {share(ms1, bnd1)} (median, CUDA "
          "events, launches queued in a row)", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
            "frames": len(frames), "ms_1_frame": ms1,
            "plain_ms_1_frame": plain1, "bound_ms_1_frame": bnd1["bound_ms"]}


def host_cpu() -> str:
    """The host's CPU model and core count: ``lscpu``'s model name and,
    where it says none or "unknown", ``/proc/cpuinfo``'s."""
    proc = subprocess.run(["lscpu"], capture_output=True, text=True,
                          timeout=60)
    said = [ln.split(":", 1)[1].strip() for ln in proc.stdout.splitlines()
            if ln.startswith("Model name")]
    model = f"lscpu {said[0] if said else 'no model name'}"
    if not said or said[0].lower() == "unknown":
        try:
            with open("/proc/cpuinfo") as f:
                names = {ln.split(":", 1)[1].strip() for ln in f
                         if ln.startswith("model name")}
            model += f", /proc/cpuinfo {' / '.join(sorted(names)) or 'none'}"
        except OSError as e:
            model += f", /proc/cpuinfo unreadable ({e})"
    return f"{model}, {os.cpu_count()} cores"


def host_runtime_phase(card: str) -> None:
    """The host C++ runtime and the port's host tools, on the card's host
    (host numbers, printed with the CPU model):

    - the speculative planes of the 4K frame without restarts at ``{4, 6,
      8} x n_threads`` chunks (explicit ``n_chunks``), each bit for bit
      with the segment-sequential decode (``speculative=False``);
    - ``abench`` in all five modes, once;
    - the four C++ microbenchmarks on the dumped 4K streams (MICRO_REPS);
    - libjpeg's coefficients of the port's 4K SOF9 frame equal to the
      port's, where ``jpeglib.h`` is found (its absence printed);
    - the AddressSanitizer sweep over fuzz seeds ASAN_SEEDS: no report."""
    import tempfile

    from jpeg_tpu_torch import bench, runtime
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.tools import abench, arith_ref, asan_sweep, microbench

    host = host_cpu()
    print(f"host_runtime: host {host}, card {card}", flush=True)
    img = synthetic_image(3840, 2160, 0)
    nr = parse_jpeg(bench.norestart_stream(img))
    want = [p.copy() for p in runtime.native_decode_planes(
        nr, speculative=False, reuse_buffer=False)]
    n_threads = os.cpu_count() or 1
    for k in (4 * n_threads, 6 * n_threads, 8 * n_threads):
        got = runtime.native_decode_planes(nr, n_chunks=k, speculative=True)
        check(all(np.array_equal(g, w) for g, w in zip(got, want)),
              f"speculative planes at {k} chunks == the sequential decode's")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as cache:
        abench.run(abench.MODES, (3840, 2160), cache,
                   out=lambda m: print(f"abench ({host}): {m}", flush=True))
        print(f"abench: five modes ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        t0 = time.perf_counter()
        microbench.microbench((3840, 2160), MICRO_REPS, MICRO_DECISIONS,
                              out=lambda m: print(f"microbench ({host}): {m}",
                                                  flush=True))
        print(f"microbench: four programs ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        if arith_ref.find_header() is None:
            print(f"jpeg_arith_ref: {arith_ref.HEADER} not found on this "
                  "host: libjpeg's QM-coder ground truth not run", flush=True)
        else:
            n, equal = arith_ref.check_port_stream(
                abench.Streams((3840, 2160), cache).get("arith"))
            check(equal, f"libjpeg's coefficients of the port's 4K SOF9 "
                  f"frame == the port's ({n} blocks)")

    t0 = time.perf_counter()
    summary = asan_sweep.sweep(*ASAN_SEEDS, out=lambda m: print(m, flush=True))
    check(summary["ok"], f"ASan sweep, fuzz seeds {ASAN_SEEDS[0]}-"
          f"{ASAN_SEEDS[1]}: {json.dumps(summary)} "
          f"({time.perf_counter() - t0:.1f} s)")


def bench_phase(card: str) -> dict:
    """``jpeg_tpu_torch.bench.main`` in a quick mode (BENCH_FRAMES headline
    frames, one repeat), its result line printed among these: its keys are
    ``bench.KEYS``, every rate finite and > 0, the headline corpus decoded
    with no fallback and some frames by K3, the card named as here, and
    K1, K1a, K2, K3 and K5 launched, ``spec_chunks`` ``4 x cores`` and
    ``pgo`` ``off``. Returns the launches by kernel."""
    from jpeg_tpu_torch import bench
    from jpeg_tpu_torch.entropy import device_huffman as k3
    from jpeg_tpu_torch.ops import fused_encode as k2
    from jpeg_tpu_torch.ops import fused_plane as k1
    from jpeg_tpu_torch.ops import idct_only as k56

    counters = {"K1": k1.LAUNCHES, "K1a": k1.LAUNCHES_APPROX,
                "K2": k2.LAUNCHES, "K3": k3.LAUNCHES, "K5": k56.LAUNCHES}
    for c in counters.values():
        c.reset()
    result = bench.main(["--frames", str(BENCH_FRAMES), "--repeats", "1"])
    launches = {name: c.value for name, c in counters.items()}
    detail = result["detail"]
    check(set(result) == {"metric", "value", "unit", "detail"}
          and result["metric"] == "frames_per_s_per_chip_4k_decode"
          and set(detail) == bench.KEYS,
          f"bench: the result line holds bench.py's keys less those left "
          f"out, through the renames, plus the port's ({len(detail)} keys)")
    rates = {k: detail[k] for k in detail["spread"]}
    check(all(np.isfinite(v) and v > 0 for v in rates.values()),
          f"bench: all {len(rates)} rates finite and > 0")
    check(detail["e2e_corpus_fallback_frames"] == 0
          and detail["e2e_corpus_device_frames"] > 0
          and detail["e2e_hybrid_device_frames"] > 0
          and result["value"] == detail["e2e_corpus_fps"],
          f"bench: headline {result['value']:.2f} frames/s over "
          f"{BENCH_FRAMES} 4K frames, {detail['e2e_corpus_device_frames']} "
          f"by K3, {detail['e2e_corpus_fallback_frames']} fallbacks; "
          f"e2e_hybrid {detail['e2e_hybrid_fps']:.2f} frames/s, "
          f"{detail['e2e_hybrid_device_frames']} by K3")
    cores = os.cpu_count() or 1
    check(detail["spec_chunks"] == 4 * cores and detail["pgo"] == "off",
          f"bench: spec_chunks {detail['spec_chunks']} == 4 x {cores} cores, "
          f"pgo {detail['pgo']!r}")
    check(detail["card"] == card and detail["device"] != "cpu",
          f"bench: card {detail['card']!r}, device {detail['device']!r}")
    check(all(n > 0 for n in launches.values()),
          f"bench went through the kernels: launches {launches}")
    return launches


def kernel_times(package_dir: str) -> None:
    """``--times``: every kernel of the ``jpeg_tpu_torch`` under
    ``package_dir``, built and timed alone at the smoke's shapes (K1, and
    K1a where the package has it, at 8 and 62 4K frames; K2, K4 at 1 and 8;
    K3 at 1, 8 and 32; K5 and K6 at
    [4096, 3840], also one launch at a time after an L2 flush; K7, where the
    package has it, on a 4K frame without restart markers at 2,048 lanes),
    launches queued in a row behind a busy card so the wrappers' host time
    stays out; then the two passes of K3 and K4 apart, and K7's kernel
    without its outputs' zeroing. Prints one line per time."""
    sys.path.insert(0, package_dir)
    import torch

    import jpeg_tpu_torch
    from jpeg_tpu_torch import runtime
    from jpeg_tpu_torch.entropy import device_huffman as k3
    from jpeg_tpu_torch.entropy import device_kernel as k4
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.ops import fused_encode as k2
    from jpeg_tpu_torch.ops import fused_plane as k1
    from jpeg_tpu_torch.ops import idct_only as k56

    try:
        from jpeg_tpu_torch.entropy import device_spec as k7
    except ImportError:  # a checkout from before K7
        k7 = None

    dev = torch.device("cuda")
    print(f"package: {os.path.dirname(os.path.abspath(jpeg_tpu_torch.__file__))}")
    loads = (runtime.load, k1.load_kernel, k2.load_kernel, k3.load_kernel,
             k4.load_kernel, k56.load_kernel) + ((k7.load_kernel,) if k7 else ())
    with ThreadPoolExecutor(len(loads)) as pool:
        for fut in [pool.submit(load) for load in loads]:
            fut.result()
    rows, cols = IDCT_SHAPE
    x = torch.from_numpy(np.random.default_rng(0).integers(-512, 512, (rows, cols))
                         .astype(np.int16)).to(dev)
    qpat = torch.from_numpy(k56.quant_pattern(np.arange(1, 65), 128, 256)).to(dev)
    for name, run in (("K5", k56.idct_only_kernel(rows, cols)),
                      ("K6", k56.idct_only_kernel_roll(rows, cols))):
        ms = cuda_ms(lambda: run(x, qpat), 10, 3, inner=20, queued=True)
        cold = cuda_ms_flushed(lambda: run(x, qpat), 20)
        print(f"times {name} [{rows}, {cols}]: {ms:.4f} ms; after an L2 "
              f"flush {cold:.4f} ms", flush=True)
    del x, qpat
    planes, qtabs, geom, _ = k1_inputs(
        [parse_jpeg(read(FRAMES_4K[i % 2])) for i in range(CORPUS_4K)], dev)
    modes = ("exact", "approx") if hasattr(k1, "LAUNCHES_APPROX") else ("exact",)
    for n in (BATCH, CORPUS_4K):  # contiguous leading slices
        p, q = [pl[:n] for pl in planes], qtabs[:n]
        for mode in modes:
            ms = cuda_ms(lambda: k1.fused_plane_decode(p, q, geom,
                                                       idct_mode=mode),
                         10, 2, inner=10 if n == BATCH else 3, queued=True)
            print(f"times {'K1a' if mode == 'approx' else 'K1'} {n}x4K: "
                  f"{ms:.4f} ms", flush=True)
    del planes, qtabs
    frames = [synthetic_image(3840, 2160, seed=i % 2) for i in range(BATCH)]
    geom, rgb, iq = k2_inputs(frames, dev, subsampling=(2, 2))
    for n in (1, BATCH):
        ms = cuda_ms(lambda: k2.fused_plane_encode(rgb[:n], iq[:n], geom),
                     10, 2, inner=20, queued=True)
        print(f"times K2 {n}x4K: {ms:.4f} ms", flush=True)
    del rgb
    plans = [parse_jpeg(read(FRAMES_4K[i % 2])) for i in range(max(K3_FRAMES))]
    for n in K3_FRAMES:
        b = k3.prepare_lane_batch(plans[:n])
        t = k3.lane_tensors(b, dev)
        m = len(b.lane_start)
        ms = cuda_ms(lambda: k3.decode_lanes(t, m, b.total_rows), 10, 2,
                     inner=5, queued=True)
        print(f"times K3 {n}x4K: {ms:.4f} ms", flush=True)
    run_1, args_1, _, _ = k4.kernel_runner(plans[0], device=dev)
    run_n, args_n, _, _, _ = k4.kernel_runner_batch(plans[:BATCH], device=dev)
    for n, run, args in ((1, run_1, args_1), (BATCH, run_n, args_n)):
        ms = cuda_ms(lambda: run(*args), 10, 2, inner=2, queued=True)
        print(f"times K4 {n}x4K: {ms:.4f} ms", flush=True)
    profiled = []
    if k7 is not None:  # a frame without restart markers, 2,048 lanes
        spec = parse_jpeg(jpeg_tpu_torch.encode_rgb(
            synthetic_image(3840, 2160, seed=0), quality=QUALITY,
            subsampling=(2, 2), restart_interval_mcus=0))
        ls, ce, se, groups = k7._chunk_lanes(spec, 2048)
        cap = k7.spec_cap(groups, k7.OVERLAP_MCUS)
        t7 = k7.spec_tensors(spec, ls, ce, se, dev)
        args_7 = (t7, len(spec.scan_data), cap, k7.OVERLAP_MCUS,
                  len(spec.components))
        ms = cuda_ms(lambda: k7.spec_lanes(*args_7), 10, 2, inner=5,
                     queued=True)
        print(f"times K7 1x4K, 2048 lanes: {ms:.4f} ms (its outputs' zeroing "
              "included)", flush=True)
        profiled.append(("K7 1x4K", lambda: k7.spec_lanes(*args_7)))
    # The two passes of K3 and K4 apart, and K7's kernel without the zeroing
    # of its outputs, from a profiler trace of five launches each (device
    # time by kernel name).
    from torch.profiler import ProfilerActivity, profile

    one = k3.prepare_lane_batch(plans[:1])
    lanes_1 = k3.lane_tensors(one, dev)
    for label, fn in [
            ("K3 1x4K", lambda: k3.decode_lanes(lanes_1, len(one.lane_start),
                                                one.total_rows)),
            ("K4 1x4K", lambda: run_1(*args_1)),
            (f"K4 {BATCH}x4K", lambda: run_n(*args_n))] + profiled:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        found = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
            for name in ("boundary_pass", "block_pass", "huffman_words_kernel",
                         "spec_lanes"):
                if name in ev.key and t and ev.count:
                    found[name] = t / ev.count / 1e3
        print(f"passes {label}: " + (", ".join(
            f"{k} {v:.4f} ms" for k, v in sorted(found.items()))
            or "not measured (the profiler saw no device time)"), flush=True)


def scale_out(dev, card: str, items, hybrid, host_res, sources) -> dict:
    """The scale-out layer (``parallel/mesh.py``, ``parallel/batch.py``,
    ``parallel/pipeline.py``, ``parallel/dryrun.py``) on the card: each
    sharded route bit for bit with its unsharded route, the kernels it
    launches counted with the counters set to 0 just before it. Meshes:
    ``make_mesh()`` over the visible cards, and grids that name this card
    several times (shards on one device run in turn). Times show what the
    mesh route costs on one card; they are no scaling figure. Returns the
    launches of each drive by kernel."""
    from collections import Counter

    import torch

    from jpeg_tpu_torch import encode_rgb
    from jpeg_tpu_torch.entropy import device_huffman as k3
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.models.decoder import (
        PipelineGeometry,
        decode_coefficients_host,
        plan_matrices,
    )
    from jpeg_tpu_torch.ops import fused_encode as k2
    from jpeg_tpu_torch.ops import fused_plane as k1
    from jpeg_tpu_torch.parallel import batch
    from jpeg_tpu_torch.parallel.dryrun import dryrun_multichip
    from jpeg_tpu_torch.parallel.mesh import make_mesh
    from jpeg_tpu_torch.parallel.pipeline import BatchedCorpusDecoder

    counters = {"K1": k1.LAUNCHES, "K2": k2.LAUNCHES, "K3": k3.LAUNCHES}
    launches = {}

    def drive(name, fn):
        """``fn()`` with every counter set to 0 just before it, read just
        after; returns its result."""
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = {k: c.value for k, c in counters.items()}
        return out

    # a. make_mesh() over the visible cards, and a (2, 2) grid of this card.
    mesh = make_mesh()
    n_cards = torch.cuda.device_count()
    check(mesh.shape == {"data": n_cards, "seg": 1},
          f"make_mesh() over the visible cards: {mesh.shape}")
    grid = make_mesh(2, 2, devices=[dev] * 4)
    plans = [parse_jpeg(read(FRAMES_4K[i % 2])) for i in range(BATCH)]
    planes, qtabs, geom, _ = k1_inputs(plans, dev)
    want = batch.decode_batch_fast(planes, qtabs, geom, device=dev)
    for name, m in (("fast_mesh", mesh), ("fast_grid", grid)):
        got = drive(name, lambda: batch.decode_batch_fast(planes, qtabs, geom,
                                                          mesh=m))
        check(torch.equal(got, want) and launches[name]["K1"]
              == m.shape["data"],
              f"decode_batch_fast(mesh={m.shape}) on {BATCH} 4K frames == "
              f"the unsharded K1 call bit for bit; K1 launched "
              f"{launches[name]['K1']} times, once per data shard")
        del got
    t = {}  # in turns: unsharded, (1, 1) mesh, (2, 2) grid, unsharded
    for name, call in (
            ("unsharded", lambda: batch.decode_batch_fast(
                planes, qtabs, geom, device=dev)),
            ("mesh", lambda: batch.decode_batch_fast(
                planes, qtabs, geom, mesh=mesh)),
            ("grid", lambda: batch.decode_batch_fast(
                planes, qtabs, geom, mesh=grid)),
            ("unsharded again", lambda: batch.decode_batch_fast(
                planes, qtabs, geom, device=dev))):
        t[name] = (cuda_ms(call, 10, 2, queued=True), cuda_ms(call, 10, 2))
    print(f"decode_batch_fast {BATCH}x4K, ms queued / unqueued (median, CUDA "
          "events; " + card + "): " + ", ".join(
              f"{k} {q:.4f} / {u:.4f}" for k, (q, u) in t.items()), flush=True)
    times = {"fast_unsharded_ms": t["unsharded"][0],
             "fast_mesh_ms": t["mesh"][0], "fast_grid_ms": t["grid"][0],
             "fast_unsharded_again_ms": t["unsharded again"][0]}
    try:
        batch.decode_batch_rows_sp_fast(planes, qtabs, geom, grid)
        refused = False
    except ValueError:
        refused = True
    check(refused, "decode_batch_rows_sp_fast refuses the 4K geometry (135 "
          "MCU rows hold no whole 8-row bands per seg shard), as JAX does")
    del planes, qtabs, want

    # b. Bands over seg: K1 at the band's geometry on 3840x2048 frames.
    streams = [encode_rgb(synthetic_image(*BAND_FRAME, seed=seed),
                          quality=QUALITY, subsampling=(2, 2),
                          restart_interval_mcus=RESTART_4K)
               for seed in (20, 21)]
    bplans = [parse_jpeg(streams[i % 2]) for i in range(4)]
    planes, qtabs, bgeom, _ = k1_inputs(bplans, dev)
    want = batch.decode_batch_fast(planes, qtabs, bgeom, device=dev)
    got = drive("rows_sp_fast", lambda: batch.decode_batch_rows_sp_fast(
        planes, qtabs, bgeom, grid))
    check(torch.equal(got, want) and launches["rows_sp_fast"]["K1"] == 4,
          f"decode_batch_rows_sp_fast on a (2, 2) grid, 4 "
          f"{BAND_FRAME[0]}x{BAND_FRAME[1]} frames: == the unsharded K1 call "
          f"bit for bit; K1 launched {launches['rows_sp_fast']['K1']} times, "
          f"once per band at its local geometry (mcus_y "
          f"{bgeom.mcus_y // 2} of {bgeom.mcus_y})")
    del got
    band = cuda_ms(lambda: batch.decode_batch_rows_sp_fast(
        planes, qtabs, bgeom, grid), 10, 2, queued=True)
    whole = cuda_ms(lambda: batch.decode_batch_fast(
        planes, qtabs, bgeom, device=dev), 10, 2, queued=True)
    print(f"4x{BAND_FRAME[0]}x{BAND_FRAME[1]}: band route {band:.4f} ms, "
          f"unsharded K1 call "
          f"{whole:.4f} ms (median, CUDA events, queued; {card})", flush=True)
    times.update(rows_sp_fast_ms=band, rows_sp_fast_unsharded_ms=whole)
    del planes, qtabs, want

    # c. The compat route over (data, seg) and its metrics at 4K: n_seg 3
    #    divides the 135 MCU rows.
    cplans = [parse_jpeg(read(FRAMES_4K[i])) for i in range(2)]
    cgeom = PipelineGeometry.of(cplans[0])
    coeffs = torch.from_numpy(np.stack(
        [decode_coefficients_host(p).copy() for p in cplans])).to(dev)
    mats = torch.from_numpy(np.stack([plan_matrices(p) for p in cplans])).to(dev)
    want = batch.decode_batch(coeffs, mats, cgeom, device=dev)
    rows3 = make_mesh(2, 3, devices=[dev] * 6)
    t0 = time.perf_counter()
    got, frames = batch.decode_batch_rows_sp(coeffs, mats, cgeom, rows3)
    torch.cuda.synchronize()
    rows_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(got, want) and frames == 2,
          "decode_batch_rows_sp on a (2, 3) grid, 2 3840x2160 frames: == the "
          f"unsharded compat decode bit for bit, {frames} frames")
    got, frames, blocks = batch.decode_batch_with_metrics(coeffs, mats, cgeom,
                                                          grid)
    check(torch.equal(got, want) and frames == 2
          and blocks == 2 * cgeom.total_blocks,
          f"decode_batch_with_metrics on the (2, 2) grid: == the unsharded "
          f"decode, frames {frames}, blocks {blocks} (exact)")
    print(f"decode_batch_rows_sp 2x4K on (2, 3): {rows_ms:.1f} ms (host "
          f"clock, first call; {card})", flush=True)
    del coeffs, mats, got, want

    # d. K2 over the data axis.
    frames8 = [sources[i % 2] for i in range(BATCH)]
    egeom, rgb, iq = k2_inputs(frames8, dev, subsampling=(2, 2))
    want = batch.encode_batch_device(rgb, iq, egeom, device=dev)
    got = drive("encode", lambda: batch.encode_batch_device(rgb, iq, egeom,
                                                            mesh=grid))
    check(all(torch.equal(g, w) for g, w in zip(got, want))
          and launches["encode"]["K2"] == 2,
          f"encode_batch_device(mesh=(2, 2) grid) on {BATCH} 4K frames == the "
          f"unsharded K2 call bit for bit; K2 launched "
          f"{launches['encode']['K2']} times, once per data shard")
    del rgb, iq, got, want

    # e. The main path's corpus under the grid: K3's device thread, then per
    #    geometry bucket one K1 launch a data shard for the largest multiple
    #    of the grid's size (60 of the 62 4K frames) and one for the rest.
    buckets = Counter(PipelineGeometry.of(parse_jpeg(d)) for d in items)
    expect = sum((grid.shape["data"] if n >= grid.size else 0)
                 + (1 if n % grid.size else 0) for n in buckets.values())
    dec = BatchedCorpusDecoder(hybrid_device=True, device_batch=BATCH,
                               device=dev, mesh=grid)
    t0 = time.perf_counter()
    res = drive("corpus", lambda: dec.decode_all(items))
    wall = time.perf_counter() - t0
    dec.close()
    n = launches["corpus"]
    check(all(r.ok for r in res) and n["K1"] == dec.pixel_launches == expect
          and n["K3"] > 0 and dec.device_frames > 0,
          f"BatchedCorpusDecoder(mesh=(2, 2) grid, hybrid_device=True) on the "
          f"{len(items)} items: K1 launched {n['K1']} times (expected "
          f"{expect}: buckets of {sorted(buckets.values())} frames), K3 "
          f"{n['K3']} times, {dec.device_frames} frames decoded by K3")
    check(all(np.array_equal(r.rgb, h.rgb) and np.array_equal(r.rgb, c.rgb)
              for r, h, c in zip(res, hybrid, host_res)),
          "every frame under the mesh == the unsharded hybrid route == the "
          "C++ host route, bit for bit")
    print(f"corpus under the (2, 2) grid: {len(items)} frames in {wall:.3f} s "
          f"= {len(items) / wall:.2f} frames/s (host clock, transfers "
          f"included; {card})", flush=True)
    del res

    # f. Every sharded route once more, small, over eight shards of this
    #    card.
    out = drive("dryrun", lambda: dryrun_multichip(8, devices=[dev] * 8))
    check(launches["dryrun"]["K1"] > 0 and launches["dryrun"]["K3"] > 0,
          f"dryrun_multichip(8) on the card: mesh {out['mesh']}, launches "
          f"{launches['dryrun']}")
    return {"launches": launches, **times}


def encode_path(frames) -> tuple[list[bytes], int, int]:
    """The encode path: ``encode_rgb_device`` on each frame (K2 + K8, the
    Huffman pack on the card), the CPU route's bytes, the host encoder on
    the same frames, and the route K8 replaced (planes downloaded, the C++
    pack) stage by stage, held to the same bytes. Returns (the device
    streams, K2 launches, K8 launches), both counted over the timed frames
    alone and checked to be one a frame."""
    import torch

    from jpeg_tpu_torch import decode_bytes, encode_rgb, encode_rgb_device
    from jpeg_tpu_torch.models.encoder import device_inputs, pack_planes
    from jpeg_tpu_torch.ops import fused_encode as k2
    from jpeg_tpu_torch.ops import huffman_encode as k8
    from jpeg_tpu_torch.parallel.batch import encode_batch_device

    kw = dict(quality=QUALITY, subsampling=(2, 2),
              restart_interval_mcus=RESTART_4K)
    encode_rgb_device(frames[0], device="cuda", **kw)  # warm-up
    k2.LAUNCHES.reset()
    k8.LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = [encode_rgb_device(f, device="cuda", **kw) for f in frames]
    wall = time.perf_counter() - t0
    launches, k8_launches = k2.LAUNCHES.value, k8.LAUNCHES.value
    check(launches == len(frames),
          f"encode path went through K2: {launches} launches for "
          f"{len(frames)} frames")
    check(k8_launches == len(frames),
          f"encode path packed on the card (K8): {k8_launches} launches for "
          f"{len(frames)} frames")

    # The same frames again, stage by stage.
    stage = dict.fromkeys(("host prep (pad, tables)", "H2D + K2",
                           "D2H of planes", "C++ pack + container"), 0.0)
    names = list(stage)
    for f, want in zip(frames, streams):
        t = [time.perf_counter()]
        geom, planar, iq, quant_zz = device_inputs(f, QUALITY, (2, 2))
        t.append(time.perf_counter())
        planes = encode_batch_device(planar[None], iq[None], geom, "cuda")
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        host = [p[0].cpu().numpy() for p in planes]
        t.append(time.perf_counter())
        data = pack_planes(host, geom, quant_zz, RESTART_4K)
        t.append(time.perf_counter())
        if data != want:
            raise CheckFailed("staged encode differs from encode_rgb_device")
        for i, n in enumerate(names):
            stage[n] += t[i + 1] - t[i]
    print("encode_rgb_device stages over "
          f"{len(frames)} frames (host clock, s): "
          + ", ".join(f"{n} {v:.3f}" for n, v in stage.items()), flush=True)

    cpu = encode_rgb_device(frames[0], device="cpu", **kw)
    check(cpu == streams[0],
          "encode_rgb_device bytes: device='cuda' == device='cpu' "
          f"({len(cpu)} bytes)")

    t0 = time.perf_counter()
    host_streams = [encode_rgb(f, **kw) for f in frames]
    host_wall = time.perf_counter() - t0
    p = psnr(decode_bytes(host_streams[0], device="cuda"),
             decode_bytes(streams[0], device="cuda"))
    check(p >= 45.0, f"host encode_rgb vs encode_rgb_device, decoded: "
          f"{p:.2f} dB >= 45")
    h, w = frames[0].shape[:2]
    print(f"encode {len(frames)}x{w}x{h} q{QUALITY} 4:2:0: encode_rgb_device "
          f"{len(frames) / wall:.3f} frames/s ({wall:.3f} s, host clock, "
          f"transfers included), mean stream {np.mean([len(x) for x in streams]):.0f} "
          f"bytes; host encode_rgb {len(frames) / host_wall:.3f} frames/s "
          f"({host_wall:.3f} s), mean stream "
          f"{np.mean([len(x) for x in host_streams]):.0f} bytes", flush=True)
    return streams, launches, k8_launches


def round_trip(streams, sources) -> tuple[int, int]:
    """Encode -> decode: the device streams, repeated to ROUND_TRIP items,
    through the hybrid corpus decoder. Returns (K1, K3) launches."""
    import torch

    from jpeg_tpu_torch.entropy import device_huffman as k3
    from jpeg_tpu_torch.ops import fused_plane as k1
    from jpeg_tpu_torch.parallel.pipeline import BatchedCorpusDecoder

    items = [streams[i % len(streams)] for i in range(ROUND_TRIP)]
    dec = BatchedCorpusDecoder(hybrid_device=True, device_batch=BATCH,
                               device="cuda")
    k1.LAUNCHES.reset()
    k3.LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = dec.decode_all(items)
    wall = time.perf_counter() - t0
    k1_launches, k3_launches = k1.LAUNCHES.value, k3.LAUNCHES.value
    dec.close()
    check(all(r.ok for r in got),
          f"round trip: all {len(items)} items decoded "
          f"({[r.error for r in got if not r.ok]})")
    check(k1_launches > 0 and k3_launches > 0 and dec.device_frames > 0,
          f"round trip went through the kernels: K1 launches {k1_launches}, "
          f"K3 launches {k3_launches}, device-decoded frames "
          f"{dec.device_frames}, fallbacks {dec.fallback_frames}")
    host = BatchedCorpusDecoder(hybrid_device=False, device="cuda")
    want = host.decode_all(items)
    host.close()
    check(all(h.ok and np.array_equal(h.rgb, g.rgb) for h, g in zip(want, got)),
          "round trip: hybrid route == host route, every frame bit for bit")
    worst = min(psnr(r.rgb, sources[i % 2]) for i, r in enumerate(got))
    check(worst > 30.0, f"round trip: every frame's PSNR vs its source image "
          f"> 30 dB (worst {worst:.2f} dB)")
    print(f"round trip: {len(items)} frames decoded in {wall:.3f} s = "
          f"{len(items) / wall:.2f} frames/s, transfers included; device "
          f"share {dec.device_frames / len(items):.3f}", flush=True)
    return k1_launches, k3_launches


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if "--times" in sys.argv[1:]:
        at = sys.argv.index("--package") + 1 if "--package" in sys.argv else 0
        kernel_times(os.path.abspath(sys.argv[at]) if at else REPO)
        return 0
    sys.path.insert(0, REPO)
    try:
        import jpeg_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the jpeg_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    try:
        kernels = run()
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"smoke: {time.perf_counter() - t0:.1f} s, builds included",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
