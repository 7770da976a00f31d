"""K7's lanes x overlap ladder: the port's counterpart of the repo-root
``tools/bench_device_spec.py``.

    python -m jpeg_tpu_torch.tools.bench_device_spec [LANES:OVERLAP ...]
        [--repeats N] [--size WxH] [--device cuda|cpu]

Runs ``decode_coefficients_device_spec`` (K7's phase A on the card, the host
merge, the relocate) on a 4K frame with a restart marker per MCU row and on
one without restarts, for each config (default: the JAX tool's ladder,
:data:`CONFIGS`), and prints one JSON line per config and frame: ``tag``
(``rst`` / ``norst``), ``lanes``, ``overlap``, ``cap``, ``fps`` (1 / the
median whole call), ``gap_mcus``, ``exact`` (equal to the C++ decoder's
coefficients), and the median milliseconds of the whole call (host clock,
completion forced by a device-to-host copy of a checksum, as in the JAX
tool) and of K7 alone (CUDA events around phase A on the same lanes;
``null`` on the CPU, where no device time exists). A config whose merge
fails prints ``fps`` 0 and its ``stats``. Exit 1 if any decoded config is
not exact.

The frames are ``jpeg_tpu_torch/bench.py``'s: the restart frame is the
committed fixture that is byte for byte ``bench.py::make_4k_jpeg()``; the
frame without restarts is the port's ``encode_rgb`` of the same pixels at
q85 4:2:0 (the JAX tool encodes it with libjpeg, which the card's machine
lacks). At another ``--size`` both are the port's encodes.

On the CPU (``--device cpu``) K7 runs its plain twin, which steps every
lane in lockstep and is slow at 4K: give a small ``--size``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np

CONFIGS = ((512, 8), (1024, 8), (2048, 8), (1024, 16), (2048, 4))
REPEATS = 3


def parse_config(text: str) -> tuple[int, int]:
    """``LANES:OVERLAP`` -> (lanes, overlap)."""
    lanes, overlap = text.split(":")
    return int(lanes), int(overlap)


def frames(size: tuple[int, int]) -> list[tuple[str, bytes]]:
    """[("rst", restart-per-row frame), ("norst", frame without restarts)]."""
    from jpeg_tpu_torch.bench import (
        FRAMES_4K,
        norestart_stream,
        restart_frame,
    )
    from jpeg_tpu_torch.io.corpus import synthetic_image

    return [("rst", restart_frame(size, 0, FRAMES_4K[0])),
            ("norst", norestart_stream(synthetic_image(*size, 0)))]


def k7_ms(plan, lanes: int, overlap: int, repeats: int, device) -> float | None:
    """Median milliseconds of K7 alone (phase A) on the lanes the call
    builds, by CUDA events; None on the CPU."""
    import torch

    from jpeg_tpu_torch.entropy import device_spec as k7

    if torch.device(device).type != "cuda":
        return None
    ls, ce, se, groups = k7._chunk_lanes(plan, lanes)
    cap = k7.spec_cap(groups, overlap)
    t = k7.spec_tensors(plan, ls, ce, se, device)
    args = (t, len(plan.scan_data), cap, overlap, len(plan.components))
    k7.spec_lanes(*args)  # warm
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        k7.spec_lanes(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(plan, lanes: int, overlap: int, repeats: int = REPEATS,
        device="cuda") -> dict:
    """One rung: a warm call, then ``repeats`` timed whole calls, each ended
    by a device-to-host copy of the coefficients' checksum. Returns
    ``coeffs`` (the last call's, None when the merge failed), ``stats``,
    ``ms`` (median whole call, host clock; None when the merge failed) and
    ``k7_ms`` (:func:`k7_ms`)."""
    import torch

    from jpeg_tpu_torch.entropy.device_spec import (
        decode_coefficients_device_spec,
    )

    def call():
        return decode_coefficients_device_spec(
            plan, target_lanes=lanes, overlap_mcus=overlap, device=device)

    coeffs, stats = call()
    if coeffs is None:
        return {"coeffs": None, "stats": stats, "ms": None, "k7_ms": None}
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        coeffs, stats = call()
        float(coeffs.to(torch.float32).sum())  # D2H: forces completion
        times.append((time.perf_counter() - t0) * 1e3)
    return {"coeffs": coeffs, "stats": stats, "ms": statistics.median(times),
            "k7_ms": k7_ms(plan, lanes, overlap, repeats, device)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jpeg_tpu_torch.tools.bench_device_spec",
        description=__doc__.split("\n\n")[0])
    p.add_argument("configs", nargs="*", type=parse_config,
                   help="LANES:OVERLAP (default: the JAX tool's ladder)")
    p.add_argument("--repeats", type=int, default=REPEATS)
    p.add_argument("--size", default="3840x2160", help="frame WxH")
    p.add_argument("--device", default="cuda",
                   help="cuda (K7) or cpu (its plain twin)")
    args = p.parse_args(argv)
    import torch

    from jpeg_tpu_torch.cli import _device
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.runtime import native_decode_coefficients

    dev = _device(args.device)  # no card is an error, not a CPU run
    size = tuple(int(x) for x in args.size.split("x"))
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    bad = 0
    for tag, data in frames(size):
        plan = parse_jpeg(data)
        ref = native_decode_coefficients(plan, reuse_buffer=False)
        for lanes, overlap in args.configs or CONFIGS:
            r = run(plan, lanes, overlap, args.repeats, dev)
            if r["coeffs"] is None:
                print(json.dumps({"tag": tag, "lanes": lanes,
                                  "overlap": overlap, "fps": 0.0,
                                  "stats": r["stats"]}), flush=True)
                continue
            exact = bool(np.array_equal(r["coeffs"].cpu().numpy(), ref))
            bad += not exact
            print(json.dumps({
                "tag": tag, "lanes": r["stats"]["lanes"], "overlap": overlap,
                "cap": r["stats"]["cap"], "fps": 1e3 / r["ms"],
                "gap_mcus": r["stats"]["gap_mcus"], "exact": exact,
                "ms": r["ms"], "k7_ms": r["k7_ms"], "device": name}),
                flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
