"""Dump a sequential scan's decode arrays to flat ``.bin`` files for the C++
microbenchmarks (``csrc/profile_entropy.cpp``, ``csrc/profile_arith.cpp``):
the port's counterpart of the repo-root ``tools/dump_scan.py``, the same
files byte for byte, from the port's ``parse_jpeg`` and ``plane_shapes``.

    python -m jpeg_tpu_torch.tools.dump_scan <jpeg-file> <out-dir>
"""

from __future__ import annotations

import os
import sys

import numpy as np

from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.runtime import plane_shapes


def dump(data: bytes, outdir: str) -> str:
    """Write the arrays of ``data``'s scan into ``outdir``; returns the
    summary line."""
    os.makedirs(outdir, exist_ok=True)
    plan = parse_jpeg(data)
    slots = plan.component_block_slots()
    comps = plan.components
    segs = plan.segments
    arrays = {
        "data.u8": np.ascontiguousarray(plan.scan_data, np.uint8),
        "seg_start.i64": np.array([s.byte_start for s in segs], np.int64),
        "seg_end.i64": np.array([s.byte_end for s in segs], np.int64),
        "seg_mcu_start.i64": np.array([s.mcu_start for s in segs], np.int64),
        "seg_mcu_count.i64": np.array([s.mcu_count for s in segs], np.int64),
        "slot_comp.u8": np.array([ci for ci, _ in slots], np.uint8),
        "slot_vi.u8": np.array([sub // comps[ci].h for ci, sub in slots],
                               np.uint8),
        "slot_hi.u8": np.array([sub % comps[ci].h for ci, sub in slots],
                               np.uint8),
        "comp_dc.u8": np.array([c.dc_id for c in comps], np.uint8),
        "comp_ac.u8": np.array([c.ac_id for c in comps], np.uint8),
        "comp_h.u8": np.array([c.h for c in comps], np.uint8),
        "comp_v.u8": np.array([c.v for c in comps], np.uint8),
    }
    if getattr(plan, "arith_code", False):
        arrays["dc_L.u8"] = np.array(plan.arith_dc_L, np.uint8)
        arrays["dc_U.u8"] = np.array(plan.arith_dc_U, np.uint8)
        arrays["ac_K.u8"] = np.array(plan.arith_ac_K, np.uint8)
    else:
        for kind, tables in (("dc", plan.dc_tables), ("ac", plan.ac_tables)):
            arrays[f"{kind}_luts.u16"] = np.ascontiguousarray(np.stack(
                [(t.lut_value.astype(np.uint16) << 8) | t.lut_length
                 for t in tables]))
    shapes = plane_shapes(plan)
    arrays["meta.i64"] = np.array(
        [plan.blocks_per_mcu, len(comps), plan.mcus_x, plan.n_mcus, len(segs)]
        + [v for s in shapes for v in s], np.int64)
    for name, arr in arrays.items():
        arr.tofile(os.path.join(outdir, name + ".bin"))
    return (f"dumped {len(arrays)} arrays to {outdir}; {len(segs)} segs, "
            f"{plan.n_mcus} mcus, shapes {shapes}")


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
