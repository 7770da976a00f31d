"""Host sanitizer sweep: the fuzz's damaged streams through the C++ runtime
and encoder built with AddressSanitizer (the "Sanitizer sweep" of the
repo-root ``tools/README.md``).

    python -m jpeg_tpu_torch.tools.asan_sweep [--seeds A-B]

The parent builds the ASan libraries (``runtime.ASAN_BUILDS``: the shipping
compiler line plus ``-fsanitize=address -fno-omit-frame-pointer``, their
own hash names in ``jpeg_tpu_torch/build/``), writes the fuzz's 20 clean
variants and their damaged cases for seeds A..B inclusive (default 0-2;
``jpeg_tpu_torch.tools.fuzz``'s recipe) to a temporary directory, and runs
one child under ``LD_PRELOAD=<gcc's libasan.so>``, ``ASAN_OPTIONS=
detect_leaks=0`` and ``JPEG_TPU_ASAN=1``. The child is this file run by
path: it loads ``jpeg_tpu_torch`` as a bare namespace, so that the
package's ``__init__`` (which imports torch) never runs, and reaches only
numpy modules (``runtime``, ``io/container.py``, ``entropy/tables.py``,
``ops/zigzag.py``, the progressive encoder's table code). Per case it
drives every C++ entry point the stream's kind takes: the plane decode
(segment-parallel or speculative, and speculative in 8 chunks), the block
decode, the gap decode over the whole scan, the byte unstuffing, the
progressive, arithmetic and lossless decoders; per clean variant that the
plane decode takes, the Huffman, arithmetic and progressive encoders on its
decoded coefficients.

A decode may raise ``ValueError`` (a damaged stream); any other exception
is a failure, as in the fuzz. The sweep fails (exit 1) on any
AddressSanitizer report, a child that does not exit 0 or a failure, and
prints a summary line ``asan sweep: ...`` last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import types

CHILD_TIMEOUT_S = 900
REPORT = "ERROR: AddressSanitizer"


def libasan() -> str:
    """Path of gcc's libasan, to preload."""
    path = subprocess.run(["gcc", "-print-file-name=libasan.so"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    if not os.path.isabs(path):
        raise FileNotFoundError(f"gcc has no libasan.so (it answered {path!r})")
    return path


def write_cases(lo: int, hi: int, outdir: str) -> int:
    """The clean variants (``clean_<name>.jpg``) and their damaged cases for
    seeds ``lo``..``hi`` (``case_<name>_<seed>.jpg``); returns the cases."""
    from jpeg_tpu_torch.tools import fuzz

    n = 0
    for name, data in fuzz.make_variants().items():
        with open(os.path.join(outdir, f"clean_{name}.jpg"), "wb") as f:
            f.write(data)
        for seed in range(lo, hi + 1):
            with open(os.path.join(outdir, f"case_{name}_{seed}.jpg"),
                      "wb") as f:
                f.write(fuzz.corrupt(name, data, seed))
            n += 1
    return n


def sweep(lo: int, hi: int, out=print) -> dict:
    """Build, write the cases, run the child; returns the summary."""
    from concurrent.futures import ThreadPoolExecutor

    from jpeg_tpu_torch import runtime
    from jpeg_tpu_torch.utils.build import build_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(runtime.ASAN_BUILDS)) as ex:
        for f in [ex.submit(build_library, name, cmd, srcs, hdrs)
                  for name, cmd, srcs, hdrs in runtime.ASAN_BUILDS]:
            f.result()
    t_build = time.perf_counter() - t0
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as tmp:
        n_cases = write_cases(lo, hi, tmp)
        env = {**os.environ, "LD_PRELOAD": libasan(),
               "ASAN_OPTIONS": "detect_leaks=0", "JPEG_TPU_ASAN": "1",
               "PYTHONPATH": root}
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", tmp], env=env, capture_output=True,
                              text=True, timeout=CHILD_TIMEOUT_S)
        t_child = time.perf_counter() - t1
    said = proc.stdout + proc.stderr
    reports = said.count(REPORT)
    record = None
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            record = json.loads(line)
    if reports or proc.returncode != 0 or record is None:
        for line in said.splitlines()[-60:]:
            out(f"asan child: {line}")
    summary = {"seeds": [lo, hi], "cases": n_cases, "asan_reports": reports,
               "child_rc": proc.returncode, "build_s": round(t_build, 1),
               "child_s": round(t_child, 1), **(record or {})}
    summary["ok"] = (reports == 0 and proc.returncode == 0
                     and record is not None and not record["failures"]
                     and record["cases"] == n_cases)
    return summary


# --------------------------------------------------------------------------
# The child (run by path under the preloaded ASan runtime; no torch)


def _bare_package() -> None:
    """Make ``jpeg_tpu_torch`` importable without running its ``__init__``."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = types.ModuleType("jpeg_tpu_torch")
    pkg.__path__ = [pkg_dir]
    sys.modules["jpeg_tpu_torch"] = pkg


def _sos_end(data: bytes) -> int | None:
    i = data.find(b"\xff\xda")
    if i < 0 or i + 4 > len(data):
        return None
    return i + 2 + int.from_bytes(data[i + 2 : i + 4], "big")


def _decode_calls(rt, plan, data: bytes) -> list:
    """(label, call) of every C++ decode entry point ``plan`` takes."""
    import numpy as np

    calls = []
    end = _sos_end(data)
    if end is not None and end < len(data):
        calls.append(("unstuff", lambda: rt.native_unstuff_scan(
            np.frombuffer(data, np.uint8), end)))
    if plan.lossless:
        return calls + [("lossless", lambda: rt.native_decode_lossless(plan)),
                        ("lossless_diffs",
                         lambda: rt.native_decode_lossless_diffs(plan))]
    if plan.progressive:
        return calls + [
            ("progressive", lambda: rt.native_decode_progressive(plan)),
            ("progressive_planes",
             lambda: rt.native_decode_progressive_planes(plan))]
    if plan.arith_code:
        return calls + [
            ("arith_planes", lambda: rt.native_decode_arith_planes(plan)),
            ("arith_coefficients",
             lambda: rt.native_decode_arith_coefficients(plan))]
    calls += [("coefficients", lambda: rt.native_decode_coefficients(
        plan, reuse_buffer=False))]
    if plan.precision == 8 and plan.segments:
        calls += [
            ("planes", lambda: rt.native_decode_planes(plan, reuse_buffer=False)),
            ("planes_spec8", lambda: rt.native_decode_planes(
                plan, reuse_buffer=False, speculative=True, n_chunks=8)),
            ("gap", lambda: rt.native_decode_gap(
                plan, 0, len(plan.scan_data), np.zeros(0, np.int64),
                plan.n_mcus))]
    return calls


def _encode_calls(rt, plan) -> list:
    """(label, call) of the encoders on ``plan``'s decoded coefficients."""
    import numpy as np

    from jpeg_tpu_torch.ops.zigzag import zigzag

    comps = plan.components
    planes = [p[: plan.mcus_y * c.v * 8, : plan.mcus_x * c.h * 8].copy()
              for p, c in zip(rt.native_decode_planes(plan, reuse_buffer=False),
                              comps)]
    slots = [(ci, sub // comps[ci].h, sub % comps[ci].h)
             for ci, sub in plan.component_block_slots()]
    comp_h, comp_v = [c.h for c in comps], [c.v for c in comps]
    tid = [min(c.dc_id, 1) for c in comps]
    maps = {}
    for kind, tables in (("dc", plan.dc_tables), ("ac", plan.ac_tables)):
        code = np.zeros((2, 256), np.uint32)
        length = np.zeros((2, 256), np.uint8)
        for t in range(2):
            code[t, tables[t].values] = tables[t].codes
            length[t, tables[t].values] = tables[t].lengths
        maps[kind] = (code, length)
    blocks = [zigzag(p.reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8)
                     .transpose(0, 2, 1, 3).reshape(p.shape[0] // 8,
                                                    p.shape[1] // 8, 64))
              .astype(np.int32) for p in planes]
    args = (planes, slots, comp_h, comp_v, plan.mcus_x, plan.n_mcus)
    return [
        ("encode_scan", lambda: rt.native_encode_scan(
            *args, 2, *maps["dc"], *maps["ac"], tid)),
        ("encode_arith_scan", lambda: rt.native_encode_arith_scan(
            *args, 2, tid)),
        ("encode_progressive", lambda: rt.native_encode_progressive_scans(
            blocks, list(zip(comp_h, comp_v)), plan.mcus_x, plan.mcus_y,
            plan.width, plan.height, restart_interval=3)),
    ]


def child(casedir: str) -> int:
    _bare_package()
    import traceback

    from jpeg_tpu_torch import runtime as rt
    from jpeg_tpu_torch.io.container import parse_jpeg

    assert rt.asan(), "the child runs with JPEG_TPU_ASAN=1"
    counts = {"cases": 0, "calls": 0, "value_errors": 0, "encodes": 0}
    failures = []
    for fname in sorted(os.listdir(casedir)):
        with open(os.path.join(casedir, fname), "rb") as f:
            data = f.read()
        clean = fname.startswith("clean_")
        counts["cases"] += not clean
        try:
            plan = parse_jpeg(data)
        except ValueError:
            counts["value_errors"] += 1
            continue
        calls = _decode_calls(rt, plan, data)
        if (clean and not (plan.lossless or plan.progressive or plan.arith_code)
                and plan.precision == 8 and len(plan.components) in (1, 3)):
            calls += _encode_calls(rt, plan)
            counts["encodes"] += 1
        for label, call in calls:
            counts["calls"] += 1
            try:
                call()
            except ValueError:
                counts["value_errors"] += 1
            except Exception as e:  # noqa: BLE001 — the fuzz's failure rule
                traceback.print_exc(limit=4)
                failures.append(f"{fname} {label}: {type(e).__name__}: {e}"[:300])
    print(json.dumps({**counts, "failures": failures}), flush=True)
    return 0


def _seeds(text: str) -> tuple[int, int]:
    lo, _, hi = text.partition("-")
    return int(lo), int(hi or lo)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        return child(argv[1])
    ap = argparse.ArgumentParser(prog="python -m jpeg_tpu_torch.tools.asan_sweep",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=_seeds, default=(0, 2),
                    help="fuzz seeds A-B, inclusive (default 0-2)")
    args = ap.parse_args(argv)
    summary = sweep(*args.seeds)
    print(f"asan sweep: {json.dumps(summary)}", flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
