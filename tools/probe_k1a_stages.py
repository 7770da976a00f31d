#!/usr/bin/env python3
"""Where K1a's time goes on the card: one-off copies of
``jpeg_tpu_torch/csrc/fused_plane.cu`` with one stage of K1a taken out,
each timed beside the real kernel on the smoke's 4K frames.

    python3 tools/probe_k1a_stages.py

Variants (K1a only; K1's instantiation is left as it is):

- ``kernel``: the source as it is;
- ``no_idct``: the tensor-core IDCT replaced by a zero fill of the cell's
  pixels (the copies and the colour stage stay);
- ``no_colour``: the colour stage and its stores skipped;
- ``loads_only``: only the cell's copies to shared memory;
- ``colour_only``: no copies and no IDCT, the colour stage on zeros.

The outputs of the cut variants are meaningless; only their times are
read. A copy of the frames' coefficient planes on the card (``copy_``,
read and write) is timed as the rate the memory gives a plain stream.
Needs one CUDA card and nvcc; builds into ``jpeg_tpu_torch/build/``.
Prints the card's name and power limit, then one line per time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CUTS = {
    "idct": ("    idct_stage_mma(g, s_q, bas, stage, tile_px);\n",
             "    for (int i = threadIdx.x; i < g.n_floats / 4; i += kThreads)\n"
             "      reinterpret_cast<float4*>(tile_px)[i] = "
             "make_float4(0.f, 0.f, 0.f, 0.f);\n"),
    "colour": ("  // 2. One thread per 16 pixels of a row: upsample by index, colour\n",
               "  if (kApprox) return;\n"
               "  // 2. One thread per 16 pixels of a row: upsample by index, colour\n"),
    "loads": ("  if constexpr (kApprox) stage_cell(g, stage, b, mcu_row, tile);\n", ""),
}
VARIANTS = {"kernel": (), "no_idct": ("idct",), "no_colour": ("colour",),
            "loads_only": ("idct", "colour"), "colour_only": ("loads", "idct")}


def variant_source(src: str, cuts) -> str:
    for cut in cuts:
        old, new = CUTS[cut]
        if src.count(old) != 1:
            raise SystemExit(f"probe_k1a_stages: the source no longer holds "
                             f"the {cut!r} anchor: {old.strip()!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch

    import chip_smoke as cs
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.ops import fused_plane as k1
    from jpeg_tpu_torch.utils import build

    if not torch.cuda.is_available():
        print("probe_k1a_stages: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    with open(os.path.join(build.CSRC_DIR, "fused_plane.cu")) as f:
        src = f.read()
    out_dir = os.path.join(build.BUILD_DIR, "probe_k1a_stages")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = build.find_nvcc()

    def make(name):
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(variant_source(src, VARIANTS[name]))
        lib = ctypes.CDLL(build.build_library(
            f"probe_k1a_{name}", [nvcc, *build.NVCC_FLAGS, "-I", build.CSRC_DIR,
                                  "--fmad=false"], [path]))
        k1._configure(lib)
        return lib

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(make, VARIANTS)))
    dev = torch.device("cuda")
    planes, qtabs, geom, _ = cs.k1_inputs(
        [parse_jpeg(cs.read(cs.FRAMES_4K[i % 2])) for i in range(cs.CORPUS_4K)],
        dev)
    flat = torch.cat([p.reshape(-1) for p in planes])
    dst = torch.empty_like(flat)
    ms = cs.cuda_ms(lambda: dst.copy_(flat), 10, 2, inner=5, queued=True)
    print(f"copy of the {cs.CORPUS_4K} frames' planes ({flat.numel() * 2} bytes "
          f"each way): {ms:.4f} ms, {4 * flat.numel() / ms / 1e9:.3f} TB/s read "
          "+ write", flush=True)
    del flat, dst
    load = k1.load_kernel
    try:
        for rnd in range(2):
            for name, lib in libs.items():
                k1.load_kernel = lambda lib=lib: lib
                for n in (cs.BATCH, cs.CORPUS_4K):
                    p, q = [pl[:n] for pl in planes], qtabs[:n]
                    ms = cs.cuda_ms(lambda: k1.fused_plane_decode(
                        p, q, geom, idct_mode="approx"), 10, 2, inner=5,
                        queued=True)
                    print(f"round {rnd} K1a {name} {n}x4K: {ms:.4f} ms",
                          flush=True)
    finally:
        k1.load_kernel = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
