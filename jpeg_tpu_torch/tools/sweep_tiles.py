"""K1's cell shape swept on the card: the port's counterpart of the repo-root
``tools/sweep_tiles.py``.

    python -m jpeg_tpu_torch.tools.sweep_tiles [TILE:THREADS ...]
        [--frames 1,8,62] [--reps N]

The JAX tool sweeps its Pallas kernel's ``JT_TILE_W`` and ``JT_BAND_ROWS``
(read at import, one process a configuration). K1's counterpart is its
CUDA cell (``csrc/fused_plane.cu``: ``kTileW`` Y-resolution columns and
``kThreads`` threads a thread block, 256 x 128 in the shipping build),
which K1a shares. Each shape is a variant library built from the same
source with ``-DJT_K1_TILE_W`` / ``-DJT_K1_THREADS``
(``ops/fused_plane.py::load_kernel(cell)``; the shipping build's command
line is unchanged), all built at once.

Only shapes that the plane layout admits run: tiles of 64, 128 or 256
columns (they divide the host's 256-column padding,
``ops/fused_plane.py::TILE_W``) and 64, 128 or 256 threads (a power-of-two
number of warps). A tile of 512 would need the host to pad planes to 512
columns and a tile of 32 leaves a 4:2:0 chroma row two blocks, fewer than
K1a's groups of four; other thread counts break K1a's warp striding. Such
a shape is refused with ``ValueError`` before anything is built.

For each shape and frame count (default 1, 8 and 62 4K frames, the main
path's restart-per-row fixtures), one JSON line: K1's and K1a's median
milliseconds (CUDA events, queued launches), each beside its bound (bytes
read once and written once over 3.35 TB/s, fp32 operations over
67 TFLOP/s, K1a's bf16 products over 989 TFLOP/s; the larger of the two)
and its share of it, and whether its pixels are bit-identical to the
shipping cell's (the JAX tool compares with libjpeg, which the card's
machine lacks). Exit 1 if any shape's pixels differ. Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# The default sweep: every admitted shape.
SHAPES = tuple((t, n) for t in (64, 128, 256) for n in (64, 128, 256))
FRAMES = (1, 8, 62)
REPS = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet peaks
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
# K1's fp32 operations a block (a 1-D pass: 4 products of the mirrored
# pairs and 7 sums a output, two passes) plus its 64 dequantise products,
# and 12 a pixel for colour; K1a's bf16 products per block (one m16n8k16
# and one m16n8k8 per pair of blocks), chip_smoke.py's counts.
K1_OPS_PER_BLOCK = 2 * (32 * 8 + 64 * 7) + 64
K1A_TC_OPS_PER_BLOCK = (2 * 16 * 8 * 16 + 2 * 16 * 8 * 8) // 2


def parse_shape(text: str) -> tuple[int, int]:
    """``TILE:THREADS`` -> a cell the layout admits (``ValueError`` else)."""
    from jpeg_tpu_torch.ops.fused_plane import check_cell

    tile, threads = text.split(":")
    return check_cell((int(tile), int(threads)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m jpeg_tpu_torch.tools.sweep_tiles",
        description=__doc__.split("\n\n")[0])
    p.add_argument("shapes", nargs="*", help="TILE:THREADS (default: all "
                   "nine admitted shapes)")
    p.add_argument("--frames", default=",".join(map(str, FRAMES)),
                   help="4K frames a launch, comma-separated")
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args(argv)
    try:
        args.shapes = [parse_shape(s) for s in args.shapes] or list(SHAPES)
    except ValueError as e:
        p.error(str(e))
    args.frames = [int(f) for f in args.frames.split(",")]
    return args


def bound_ms(planes, qtabs, geom, approx: bool) -> float:
    """K1's (or K1a's) least time on these inputs: the larger of its bytes
    over the memory rate and its operations over their peak rates."""
    from jpeg_tpu_torch.ops.fused_plane import padded_size

    h_pad, w_pad = padded_size(geom)
    pixels = qtabs.shape[0] * h_pad * w_pad
    blocks = sum(p.numel() for p in planes) // 64
    n_bytes = (sum(p.numel() * p.element_size() for p in planes)
               + qtabs.numel() * 4 + 3 * pixels)
    if approx:
        ops = ((blocks * 64 + 12 * pixels) / FP32_OPS_PER_S
               + blocks * K1A_TC_OPS_PER_BLOCK / BF16_TC_OPS_PER_S)
    else:
        ops = (blocks * K1_OPS_PER_BLOCK + 12 * pixels) / FP32_OPS_PER_S
    return max(n_bytes / HBM_BYTES_PER_S, ops) * 1e3


def frame_inputs(n: int, device="cuda"):
    """K1's inputs for ``n`` of the main path's 4K frames: (planes, qtabs,
    geom) on ``device``."""
    import torch

    from jpeg_tpu_torch import runtime
    from jpeg_tpu_torch.bench import FRAMES_4K, SIZE_4K, restart_frame
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.models.decoder import PipelineGeometry
    from jpeg_tpu_torch.ops.fused_plane import plan_quant_patterns

    plans = [parse_jpeg(restart_frame(SIZE_4K, s, FRAMES_4K[s]))
             for s in (0, 1)]
    host = [[p.copy() for p in runtime.native_decode_planes(pl)]
            for pl in plans]
    geom = PipelineGeometry.of(plans[0])
    planes = [torch.from_numpy(np.stack([host[i % 2][c] for i in range(n)]))
              .to(device) for c in range(len(host[0]))]
    qtabs = torch.from_numpy(np.stack(
        [plan_quant_patterns(plans[i % 2], geom) for i in range(n)])).to(device)
    return planes, qtabs, geom


def build(shapes) -> None:
    """Build every shape's library at once (one nvcc each)."""
    from jpeg_tpu_torch.ops.fused_plane import load_kernel

    with ThreadPoolExecutor(len(shapes) + 1) as pool:
        for f in [pool.submit(load_kernel, None),
                  *(pool.submit(load_kernel, s) for s in shapes)]:
            f.result()


def sweep(shapes, frames=FRAMES, reps: int = REPS, device="cuda"):
    """One record per (shape, frame count): ``tile_w``, ``threads``,
    ``frames``, and per tier (``k1``, ``k1a``) ``ms``, ``bound_ms``,
    ``share_of_bound`` and ``identical`` (pixels equal to the shipping
    cell's)."""
    import torch

    from jpeg_tpu_torch.ops.fused_plane import (
        check_cell,
        fused_plane_decode_cuda,
    )
    from jpeg_tpu_torch.utils.profiling import queued_ms

    shapes = [check_cell(s) for s in shapes]  # refused before any build
    build(shapes)
    recs = []
    for n in frames:
        planes, qtabs, geom = frame_inputs(n, device)
        want = {m: fused_plane_decode_cuda(planes, qtabs, geom, idct_mode=m)
                for m in ("exact", "approx")}
        for shape in shapes:
            rec = {"tile_w": shape[0], "threads": shape[1], "frames": n}
            for key, mode in (("k1", "exact"), ("k1a", "approx")):
                got = fused_plane_decode_cuda(planes, qtabs, geom,
                                              idct_mode=mode, cell=shape)
                same = bool(torch.equal(got, want[mode]))
                del got
                ms = queued_ms(lambda: fused_plane_decode_cuda(
                    planes, qtabs, geom, idct_mode=mode, cell=shape), reps)
                bnd = bound_ms(planes, qtabs, geom, mode == "approx")
                rec[key] = {"ms": ms, "bound_ms": bnd,
                            "share_of_bound": bnd / ms, "identical": same}
            recs.append(rec)
        del planes, qtabs, want
        torch.cuda.empty_cache()
    return recs


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from jpeg_tpu_torch.cli import _device

    dev = _device("cuda")  # no card is an error: the cells are CUDA builds
    name = torch.cuda.get_device_name(dev)
    bad = 0
    for rec in sweep(args.shapes, args.frames, args.reps, dev):
        bad += not (rec["k1"]["identical"] and rec["k1a"]["identical"])
        print(json.dumps({**rec, "device": name}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
