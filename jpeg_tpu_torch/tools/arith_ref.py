"""libjpeg ground truth for the QM (arithmetic) coder, through
``csrc/jpeg_arith_ref.c``, a verbatim copy of the repo-root
``tools/jpeg_arith_ref.c`` (the harness behind
``tests/goldens/arith_libjpeg.npz``).

    python -m jpeg_tpu_torch.tools.arith_ref <arithmetic .jpg> ...

The harness links the system libjpeg (libjpeg-turbo carries the
arithmetic codec) and is built with gcc into ``jpeg_tpu_torch/build/`` at
first use. Where ``jpeglib.h`` is missing, :func:`build` raises
:class:`BuildError` naming it: no result is ever made up. It encodes raw
pixels as SOF9 / SOF10 (:func:`encode`), decodes any stream to pixels
(:func:`decode`) and dumps the entropy layer's coefficients
(:func:`coefficients`). :func:`check_port_stream` holds libjpeg's
coefficients of a stream to the port's C++ decoder's; the command line does
that for each file and exits 1 on a difference.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

from jpeg_tpu_torch.utils.build import BuildError, build_executable

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "jpeg_arith_ref.c")
HEADER = "jpeglib.h"
RUN_TIMEOUT_S = 120


def find_header() -> str | None:
    """Path of ``jpeglib.h`` as gcc finds it, or None."""
    proc = subprocess.run(["gcc", "-H", "-fsyntax-only", "-x", "c", "-"],
                          input=f"#include <{HEADER}>\n", capture_output=True,
                          text=True)
    for line in proc.stderr.splitlines():
        if line.startswith(". ") and line.endswith(HEADER):
            return line[2:]
    return None


def build() -> str:
    """The harness, built at first use; returns its path."""
    if find_header() is None:
        raise BuildError(f"{HEADER} not found on gcc's include path: the "
                         "libjpeg harness cannot be built here")
    return build_executable("jpeg_arith_ref", ["gcc", "-O2"], [SOURCE],
                            libs=("-ljpeg",))


def _run(*args: str) -> None:
    proc = subprocess.run([build(), *args], capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"jpeg_arith_ref {args[0]} exit {proc.returncode}: "
                           f"{proc.stderr}")


def encode(img: np.ndarray, quality: int = 85, progressive: bool = False,
           restart_rows: int = 0) -> bytes:
    """libjpeg's arithmetic-coded stream (SOF9, or SOF10 when
    ``progressive``) of u8 ``img`` ([H, W, 3] RGB or [H, W] gray)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    ncomp = 1 if img.ndim == 2 else img.shape[2]
    with tempfile.TemporaryDirectory() as tmp:
        raw, out = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.jpg")
        img.tofile(raw)
        _run("encode", raw, str(w), str(h), str(ncomp), str(quality), out,
             str(int(progressive)), str(restart_rows))
        with open(out, "rb") as f:
            return f.read()


def decode(data: bytes) -> np.ndarray:
    """libjpeg's pixels of ``data``: [H, W, C] u8."""
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "in.jpg"), os.path.join(tmp, "out.raw")
        with open(src, "wb") as f:
            f.write(data)
        _run("decode", src, out)
        with open(out, "rb") as f:
            head, body = f.read().split(b"\n", 1)
    w, h, nc = (int(v) for v in head.split())
    return np.frombuffer(body, np.uint8).reshape(h, w, nc)


def coefficients(data: bytes) -> list[np.ndarray]:
    """libjpeg's quantized coefficients of ``data`` (``jpeg_read_coefficients``)
    per component: [blocks high, blocks wide, 64] int16, natural order."""
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "in.jpg"), os.path.join(tmp, "out.bin")
        with open(src, "wb") as f:
            f.write(data)
        _run("coeffs", src, out)
        with open(out, "rb") as f:
            raw = f.read()
    line, raw = raw.split(b"\n", 1)
    grids = []
    for _ in range(int(line)):
        line, raw = raw.split(b"\n", 1)
        bh, bw = (int(v) for v in line.split())
        n = bh * bw * 64 * 2
        grids.append(np.frombuffer(raw[:n], np.int16).reshape(bh, bw, 64))
        raw = raw[n:]
    return grids


def port_grids(plan, coeffs: np.ndarray) -> list[np.ndarray]:
    """The port's ``[total_blocks, 64]`` zigzag MCU-order blocks of ``plan``
    as per-component natural-order grids [mcus_y * v, mcus_x * h, 64]."""
    from jpeg_tpu_torch.ops.zigzag import unzigzag

    slots = plan.component_block_slots()
    bpm = plan.blocks_per_mcu
    my, mx = np.divmod(np.arange(plan.n_mcus), plan.mcus_x)
    grids = [np.zeros((plan.mcus_y * c.v, plan.mcus_x * c.h, 64), np.int32)
             for c in plan.components]
    for si, (ci, sub) in enumerate(slots):
        c = plan.components[ci]
        vi, hi = divmod(sub, c.h)
        grids[ci][my * c.v + vi, mx * c.h + hi] = unzigzag(coeffs[si::bpm])
    return grids


def check_port_stream(data: bytes) -> tuple[int, bool]:
    """(blocks compared, equal): libjpeg's coefficients of the sequential
    arithmetic stream ``data`` against the port's C++ decoder's
    (``native_decode_arith_coefficients``), over libjpeg's block grid."""
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.runtime import native_decode_arith_coefficients

    plan = parse_jpeg(data)
    mine = port_grids(plan, native_decode_arith_coefficients(plan))
    ref = coefficients(data)
    equal = len(mine) == len(ref)
    n = 0
    for got, want in zip(mine, ref):
        bh, bw = want.shape[:2]
        equal &= np.array_equal(got[:bh, :bw], want.astype(np.int32))
        n += bh * bw
    return n, bool(equal)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    bad = 0
    for path in argv:
        with open(path, "rb") as f:
            n, equal = check_port_stream(f.read())
        print(f"{path}: {n} blocks, libjpeg's coefficients "
              f"{'==' if equal else '!='} the port's")
        bad += not equal
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
