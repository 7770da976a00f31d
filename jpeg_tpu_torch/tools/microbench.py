"""Build and run the C++ microbenchmarks of the host entropy runtime.

    python -m jpeg_tpu_torch.tools.microbench [--size WxH] [--reps N]
        [--decisions N] [--only NAME ...]

The four programs are the repo-root ``tools/`` ones, copied verbatim into
``csrc/`` except for the one ``#include`` line, which names the port's copy
of the runtime (``runtime/native/jpegtpu.cpp``):

- ``profile_entropy``: the restart-segmented plane decode on one thread,
  with and without the bulk zeroing, the zeroing alone and the Huffman
  decode alone (into one reused tile);
- ``profile_arith``: the arithmetic (SOF9) plane decode on 1 and 4 threads;
- ``profile_prog``: every scan of a progressive frame replayed serially,
  each scan's best time;
- ``ab_qm_interleave``: the QM decoder's decision chain on one, two and
  four interleaved decoders (random bytes; ``--decisions`` decisions).

Each is compiled with g++ (their header's command line) into
``jpeg_tpu_torch/build/`` at first use, all at once. The inputs are dumped
(``dump_scan`` / ``dump_prog``) from the bench's streams at ``--size``
(default 3840x2160): the restart-per-row frame (the committed fixture at
4K), the arithmetic frame (a restart every 16 MCUs) and the progressive
frame (the committed libjpeg golden at 4K). Each program's output is
printed under its name; a program that fails raises. Host numbers: they
time the CPU, not the card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

PROGRAMS = ("profile_entropy", "profile_arith", "profile_prog",
            "ab_qm_interleave")
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
CXX = ["g++", "-O3", "-march=native", "-std=c++17", "-pthread"]
RUN_TIMEOUT_S = 300


def build(name: str) -> str:
    """The program ``name``, built at first use; returns its path."""
    from jpeg_tpu_torch import runtime
    from jpeg_tpu_torch.utils.build import build_executable

    return build_executable(name, CXX, [os.path.join(CSRC, f"{name}.cpp")],
                            headers=(runtime.SOURCE,))


def build_all(names=PROGRAMS) -> dict[str, str]:
    with ThreadPoolExecutor(len(names)) as ex:
        return dict(zip(names, ex.map(build, names)))


# The dumped stream each program reads (ab_qm_interleave reads none).
INPUT = {"profile_entropy": "scan", "profile_arith": "arith",
         "profile_prog": "prog"}


def dump_inputs(size: tuple[int, int], outdir: str, kinds) -> dict[str, str]:
    """The input directories of ``kinds`` (of INPUT's values) under
    ``outdir``, dumped from the bench's streams at ``size``."""
    from jpeg_tpu_torch import bench
    from jpeg_tpu_torch.io.corpus import synthetic_image
    from jpeg_tpu_torch.tools import dump_prog, dump_scan

    dirs = {k: os.path.join(outdir, k) for k in kinds}
    if "scan" in dirs:
        dump_scan.dump(bench.restart_frame(size, 0, bench.FRAMES_4K[0]),
                       dirs["scan"])
    if "arith" in dirs:
        dump_scan.dump(bench.arithmetic_stream(synthetic_image(*size, 0)),
                       dirs["arith"])
    if "prog" in dirs:
        dump_prog.dump(bench.progressive_stream(size), dirs["prog"])
    return dirs


def arguments(name: str, dirs: dict, reps: int, decisions: int) -> list[str]:
    if name == "ab_qm_interleave":
        return [str(decisions), str(reps)]
    return [dirs[INPUT[name]], str(reps)]


def run(path: str, args: list[str]) -> str:
    """Run a built program; its stdout, or RuntimeError with its output."""
    proc = subprocess.run([path, *args], capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(path)} {' '.join(args)} exit "
                           f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout


def microbench(size=(3840, 2160), reps: int = 3, decisions: int = 4_000_000,
               names=PROGRAMS, out=print) -> dict:
    """Build, dump and run ``names``; returns each program's stdout."""
    t0 = time.perf_counter()
    paths = build_all(names)
    out(f"microbench: built {len(paths)} programs "
        f"({time.perf_counter() - t0:.1f} s)")
    with tempfile.TemporaryDirectory() as tmp:
        dirs = dump_inputs(size, tmp, {INPUT[n] for n in names if n in INPUT})
        said = {}
        for name in names:
            said[name] = run(paths[name], arguments(name, dirs, reps,
                                                    decisions))
            for line in said[name].splitlines():
                out(f"{name}: {line}")
    return said


def main(argv=None) -> int:
    from jpeg_tpu_torch.bench import _size

    ap = argparse.ArgumentParser(prog="python -m jpeg_tpu_torch.tools.microbench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=_size, default=(3840, 2160))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--decisions", type=int, default=40_000_000,
                    help="ab_qm_interleave's decisions (its default)")
    ap.add_argument("--only", nargs="+", choices=PROGRAMS, default=PROGRAMS)
    args = ap.parse_args(argv)
    microbench(args.size, args.reps, args.decisions, tuple(args.only))
    return 0


if __name__ == "__main__":
    sys.exit(main())
