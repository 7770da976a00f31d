"""Dump a progressive frame's per-scan arrays for the C++ microbenchmark
``csrc/profile_prog.cpp``: the port's counterpart of the repo-root
``tools/dump_prog.py``, the same files byte for byte, from the port's
``parse_jpeg``.

    python -m jpeg_tpu_torch.tools.dump_prog <progressive-jpeg> <out-dir>

Layout: ``meta.i64.bin`` holds the global geometry; per scan i:
``scan<i>_data.u8.bin``, ``scan<i>_bounds.i64.bin`` (start / end pairs),
``scan<i>_meta.i64.bin`` [ss, se, ah, al, n_comps, restart_interval,
comp_idx..., dc_id..., ac_id...], ``scan<i>_dc_luts.u16.bin`` /
``scan<i>_ac_luts.u16.bin`` (packed 4 x 65536).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from jpeg_tpu_torch.io.container import parse_jpeg


def packed(tables) -> np.ndarray:
    out = np.zeros((4, 65536), np.uint16)
    for i, t in enumerate(tables):
        if t is not None and hasattr(t, "lut_value"):
            out[i] = (t.lut_value.astype(np.uint16) << 8) | t.lut_length
    return out


def dump(data: bytes, outdir: str) -> str:
    """Write the arrays of ``data``'s scans into ``outdir``; returns the
    summary line. Raises ValueError for a frame that is not progressive."""
    os.makedirs(outdir, exist_ok=True)
    plan = parse_jpeg(data)
    if not plan.progressive:
        raise ValueError("dump_prog takes a progressive (SOF2 / SOF10) frame")
    np.array([plan.width, plan.height, plan.mcus_x, plan.mcus_y, plan.n_mcus,
              len(plan.components), plan.h_max, plan.v_max,
              len(plan.prog_scans)], np.int64).tofile(
        os.path.join(outdir, "meta.i64.bin"))
    np.array([[c.h, c.v] for c in plan.components], np.int64).tofile(
        os.path.join(outdir, "comp.i64.bin"))
    for i, sc in enumerate(plan.prog_scans):
        def path(name, i=i):
            return os.path.join(outdir, f"scan{i}_{name}.bin")

        np.ascontiguousarray(sc.scan_data, np.uint8).tofile(path("data.u8"))
        np.array(sc.bounds, np.int64).tofile(path("bounds.i64"))
        np.array([sc.ss, sc.se, sc.ah, sc.al, len(sc.comp_indices),
                  sc.restart_interval or 0] + list(sc.comp_indices)
                 + list(sc.dc_ids) + list(sc.ac_ids), np.int64).tofile(
            path("meta.i64"))
        packed(sc.dc_tables).tofile(path("dc_luts.u16"))
        packed(sc.ac_tables).tofile(path("ac_luts.u16"))
    return f"dumped {len(plan.prog_scans)} scans to {outdir}"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    with open(argv[0], "rb") as f:
        print(dump(f.read(), argv[1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
