"""Readings that set a cell's limits: the program's numbers compared over
many seeds, and the control's over a few, in one process on the card.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 \
        --seconds 4 [--control-seeds 21,22,23]

The control is what a later change could be tempted to ship: for the
decode cells the program's own lower-precision tier (``idct_mode=
"approx"``, K1a: bf16 operands on the tensor cores), for the encode cell
the reference itself computed in bfloat16 in the program's place. Each is
judged exactly as a run judges the program, at the cell's own size and
load over a short window. The benchmark's own runs never run it. One JSON
line per run on stdout: ``{"seed", "side", "correct", "numbers"}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from benchmark.run import RunError, log, refuse_forbidden, run_cell
from benchmark.spec import load_cell

CONTROL = {
    "decode_all": ({"decoder_options": {"idct_mode": "approx"}}, "check"),
    "encode_rgb_device": (None, "control_check"),
}


def readings(cell, seeds, seconds: float, device, control: bool) -> list:
    options, judge = CONTROL[cell.traffic["entry"]] if control else (None, "check")
    out = []
    for seed in seeds:
        res = run_cell(cell, seed, seconds, False, device, time.perf_counter(),
                       options, judge)
        row = {"seed": seed, "side": "control" if control else "program",
               "correct": res["correct"],
               "numbers": {k: v["value"] for k, v in res["check"].items()}}
        refuse_forbidden()
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    cell = load_cell(os.getcwd(), args.workload)
    dev = torch.device("cuda", 0)
    try:
        for seeds, control in ((args.seeds, False), (args.control_seeds, True)):
            if seeds:
                readings(cell, [int(s) for s in seeds.split(",")],
                         args.seconds, dev, control)
    except RunError as e:
        log(f"run refused: {e}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
