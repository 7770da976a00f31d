"""K3's pass 1 ablated, term by term: the port's counterpart of the repo-root
``tools/ablate_kernel.py``.

    python -m jpeg_tpu_torch.tools.ablate_kernel [--streams rst16,main8]
        [--variants a,b,c,d,e,f] [--reps N]

The JAX tool takes the steps of its lockstep XLA entropy kernel apart. K3
(``csrc/huffman_lanes.cu``) answers that kernel's tier name today, and its
largest loss is pass 1, the boundary walk (``boundary_pass``): one thread a
lane, one table lookup, shift and refill a step, each step waiting for the
one before. This tool builds pass 1 again from
``jpeg_tpu_torch/tools/csrc/k3_ablate.cu`` (``huffman_common.cuh``'s
``walk_lane`` with other reader and record types) and times, with CUDA
events, the median of queued launches of each variant of :data:`VARIANTS`:

- (a) full: the shipping pass; its records and error flags are held to the
  shipping K3's pass 1 (``jt_huffman_lanes``' scratch), bit for bit;
- (b) no record store: every record into one shared-memory slot;
- (c) no refill: a reader that loads once (the refill's shifts stay);
- (d) one symbol a step: the pair table's two-symbol bit cleared;
- (e) the table in global memory instead of shared memory;
- (f) lanes a warp fixed at 1, 2, 4, 8 and 32 instead of the launcher's
  ``lanes_per_warp_for``.

Only (a) is checked; the others decode other symbols or drop records and
stand for cost alone, as in the JAX tool. Each line also gives the steps of
the longest lane (one table lookup each, counted in a separate, untimed
launch through a reader that counts its refills) and the cycles a step
they imply at the SM's 1,980 MHz boost clock (H100 SXM data sheet: an
estimate, the clock is not read), on the longest lane: pass 1 is one wave,
so its time is the slowest warp's chain.

Streams (:data:`STREAMS`): ``rst16``, the JAX tool's, a 4K frame decoded
and re-encoded at q85 4:2:0 with a 16-MCU restart interval (2,025 lanes;
the JAX tool decodes with libjpeg, this tool with the port's compat
decode: the card's machine has no Pillow); ``main8``, the main path's claim,
eight 4K frames with a restart marker per MCU row (1,080 lanes).

Runs on the card only: the variants are CUDA builds, and no CPU twin
stands for their cost. Exit 1 if (a) differs from the shipping pass.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "k3_ablate.cu")
FULL, NO_STORE, NO_REFILL, GLOBAL_TABLE = 0, 1, 2, 3  # k3_ablate.cu's modes
# (key, what, kernel mode, one symbol a step, lanes a warp or None)
VARIANTS = (
    ("a", "full", FULL, False, None),
    ("b", "no record store", NO_STORE, False, None),
    ("c", "no refill", NO_REFILL, False, None),
    ("d", "one symbol a step", FULL, True, None),
    ("e", "table in global memory", GLOBAL_TABLE, False, None),
    *(("f", f"lanes_per_warp={n}", FULL, False, n) for n in (1, 2, 4, 8, 32)),
)
STREAMS = ("rst16", "main8")
RESTART_MCUS = 16  # the JAX tool's re-encode: q85, 4:2:0, 16-MCU interval
QUALITY = 85
MAIN_FRAMES = 8
SM_CLOCK_HZ = 1.98e9
REPS = 20


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m jpeg_tpu_torch.tools.ablate_kernel",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--streams", default=",".join(STREAMS),
                   help=f"comma-separated, of {STREAMS}")
    p.add_argument("--variants", default="a,b,c,d,e,f",
                   help="comma-separated keys of VARIANTS")
    p.add_argument("--reps", type=int, default=REPS,
                   help="timed launches a variant (median)")
    args = p.parse_args(argv)
    args.streams = args.streams.split(",")
    args.variants = args.variants.split(",")
    bad = ([s for s in args.streams if s not in STREAMS]
           + [v for v in args.variants if v not in {x[0] for x in VARIANTS}])
    if bad:
        p.error(f"unknown stream or variant: {bad}")
    return args


def stream_plans(name: str, device="cuda") -> list:
    """The plans of stream ``name`` (:data:`STREAMS`)."""
    from jpeg_tpu_torch.bench import FRAMES_4K, SIZE_4K, restart_frame
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.models.decoder import decode_bytes
    from jpeg_tpu_torch.models.encoder import encode_rgb

    if name == "main8":
        return [parse_jpeg(restart_frame(SIZE_4K, i % 2, FRAMES_4K[i % 2]))
                for i in range(MAIN_FRAMES)]
    img = decode_bytes(restart_frame(SIZE_4K, 0, FRAMES_4K[0]), device=device)
    return [parse_jpeg(encode_rgb(img, quality=QUALITY, subsampling=(2, 2),
                                  restart_interval_mcus=RESTART_MCUS))]


def one_symbol_pairs(pair: np.ndarray) -> np.ndarray:
    """Pass 1's pair table with the two-symbol bit (26) cleared: every step
    consumes one symbol."""
    return (pair & ~np.int32(1 << 26)).astype(np.int32)


def _configure(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.jt_k3_ablate.restype = ctypes.c_int
    lib.jt_k3_ablate.argtypes = [
        i32, vp, vp, vp, vp, vp, i32,  # mode, data, lane arrays, n_lanes
        vp, vp, vp, vp, i32, i32, i32,  # pair, hv, canon, slots, rows, bpm, lpw
        vp, vp, vp, vp]  # meta, err, steps, stream
    lib.jt_k3_lanes_per_warp.restype = ctypes.c_int
    lib.jt_k3_lanes_per_warp.argtypes = [i32]


def load_kernel():
    """Build (at first use) and load the ablation library."""
    from jpeg_tpu_torch.utils.build import load_cuda_kernel

    return load_cuda_kernel("k3_ablate", (), _configure,
                            headers=("huffman_common.cuh",), source=SOURCE)


class Pass1:
    """One batch's lanes on the card, and launchers of the shipping pass 1
    and of the ablation variants over them."""

    def __init__(self, plans, device="cuda"):
        import torch

        from jpeg_tpu_torch.entropy import device_huffman as k3

        self.batch = k3.prepare_lane_batch(plans)
        self.t = k3.lane_tensors(self.batch, device)
        self.n = len(self.batch.lane_start)
        self.rows = self.batch.total_rows
        self.dev = torch.device(device)
        self.one_pair = torch.from_numpy(
            one_symbol_pairs(self.batch.pair)).to(self.dev)
        self.lib = load_kernel()
        self.lanes_per_warp = self.lib.jt_k3_lanes_per_warp(self.n)
        if self.lanes_per_warp < 1:
            raise RuntimeError("K3 ablation: SM count query failed")

    def _outputs(self, steps: bool):
        import torch

        meta = torch.empty((self.rows, 4), dtype=torch.int32, device=self.dev)
        err = torch.empty(self.n, dtype=torch.uint8, device=self.dev)
        st = (torch.empty(self.n, dtype=torch.int32, device=self.dev)
              if steps else None)
        return meta, err, st

    def shipping(self):
        """(meta, err) of the shipping K3's pass 1 (both passes launched)."""
        import torch

        from jpeg_tpu_torch.entropy import device_huffman as k3

        t = self.t
        meta, err, _ = self._outputs(False)
        coeffs = torch.empty((self.rows, 64), dtype=torch.int32,
                             device=self.dev)
        rc = k3.load_kernel().jt_huffman_lanes(
            t["data"].data_ptr(), t["lane_start"].data_ptr(),
            t["lane_len"].data_ptr(), t["lane_nblk"].data_ptr(),
            t["lane_out"].data_ptr(), self.n, t["skip"].data_ptr(),
            t["pair"].data_ptr(), t["skip_hv"].data_ptr(),
            t["skip_canon"].data_ptr(), t["skip_slots"].data_ptr(),
            t["skip"].shape[0], t["skip_slots"].shape[0], self.rows,
            meta.data_ptr(), coeffs.data_ptr(), err.data_ptr(),
            torch.cuda.current_stream(self.dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K3 launch failed: CUDA error {rc}")
        return meta, err

    def variant(self, mode: int, one_symbol: bool, lanes_per_warp,
                steps: bool = False, out=None):
        """Launch one variant -> (meta, err, steps or None), into ``out``
        when given (a timed loop reuses its outputs)."""
        import torch

        t = self.t
        meta, err, st = out or self._outputs(steps)
        pair = self.one_pair if one_symbol else t["pair"]
        rc = self.lib.jt_k3_ablate(
            mode, t["data"].data_ptr(), t["lane_start"].data_ptr(),
            t["lane_len"].data_ptr(), t["lane_nblk"].data_ptr(),
            t["lane_out"].data_ptr(), self.n, pair.data_ptr(),
            t["skip_hv"].data_ptr(), t["skip_canon"].data_ptr(),
            t["skip_slots"].data_ptr(), t["skip"].shape[0],
            t["skip_slots"].shape[0], lanes_per_warp or self.lanes_per_warp,
            meta.data_ptr(), err.data_ptr(),
            st.data_ptr() if st is not None else None,
            torch.cuda.current_stream(self.dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K3 ablation launch failed: CUDA error {rc}")
        return meta, err, st


def ablate(plans, keys=("a", "b", "c", "d", "e", "f"), reps: int = REPS,
           device="cuda") -> list[dict]:
    """Every variant of ``keys`` over the lanes of ``plans`` -> one record
    each: ``variant``, ``what``, ``lanes``, ``lanes_per_warp``, ``ms``,
    ``ratio_to_full``, ``steps_max`` / ``steps_total`` (the variant's own
    walk), ``cycles_per_step`` (longest lane), ``checked`` and, for (a),
    ``same_records`` (meta and err equal to the shipping pass 1)."""
    import torch

    from jpeg_tpu_torch.utils.profiling import queued_ms

    p1 = Pass1(plans, device)
    ship_meta, ship_err = p1.shipping()
    full_ms = None
    recs = []
    for key, what, mode, one, lpw in VARIANTS:
        if key not in keys and key != "a":
            continue
        meta, err, steps = p1.variant(mode, one, lpw, steps=True)
        same = None
        if key == "a":
            same = bool(torch.equal(meta, ship_meta)
                        and torch.equal(err, ship_err))
        out = p1._outputs(False)
        ms = queued_ms(lambda: p1.variant(mode, one, lpw, out=out), reps)
        if key == "a":
            full_ms = ms
            if "a" not in keys:
                continue
        steps_max = int(steps.max())
        recs.append({
            "variant": key, "what": what, "lanes": p1.n,
            "lanes_per_warp": lpw or p1.lanes_per_warp, "ms": ms,
            "ratio_to_full": ms / full_ms, "steps_max": steps_max,
            "steps_total": int(steps.to(torch.int64).sum()),
            "cycles_per_step": ms * 1e-3 * SM_CLOCK_HZ / max(steps_max, 1),
            "checked": key == "a", "same_records": same,
            "flagged_lanes": int(err.sum())})
    return recs


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from jpeg_tpu_torch.cli import _device

    dev = _device("cuda")  # no card is an error: the variants are CUDA
    name = torch.cuda.get_device_name(dev)
    bad = 0
    for stream in args.streams:
        for rec in ablate(stream_plans(stream, dev), args.variants, args.reps,
                          dev):
            rec = {"stream": stream, **rec, "device": name}
            bad += rec["same_records"] is False
            print(json.dumps(rec), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
