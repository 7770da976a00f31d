"""PPM image writer/reader.

Parity: reference CLI PPM P3 output (``src/main.rs:34-39``): ASCII header
``P3\\n<w> <h>\\n255\\n`` then one ``r g b`` line per pixel. Also provides the
binary P6 variant for large corpora (the reference only has P3).

Copy of ``jpeg_tpu/io/ppm.py``.
"""

from __future__ import annotations

import numpy as np


def write_ppm(path, rgb: np.ndarray, binary: bool = True,
              maxval: int | None = None) -> None:
    """Write [H, W, 3] u8 (maxval 255) or u16 to PPM. u16 defaults to
    maxval 4095 (12-bit decodes) unless samples exceed it (16-bit
    lossless) or ``maxval`` is given. ``binary=False`` gives
    reference-identical P3 text output (one pixel per line,
    src/main.rs:36-39); 16-bit P6 samples are big-endian per the
    Netpbm spec."""
    rgb = np.asarray(rgb)
    if rgb.dtype == np.uint16:
        if maxval is None:
            maxval = 4095 if int(rgb.max(initial=0)) <= 4095 else 65535
    else:
        rgb = rgb.astype(np.uint8)
        maxval = 255
    h, w, _ = rgb.shape
    if binary:
        with open(path, "wb") as f:
            f.write(f"P6\n{w} {h}\n{maxval}\n".encode())
            if maxval > 255:
                f.write(rgb.astype(">u2").tobytes())
            else:
                f.write(rgb.tobytes())
    else:
        flat = rgb.reshape(-1, 3)
        lines = [f"P3\n{w} {h}\n{maxval}\n"]
        lines += [f"{r} {g} {b}\n" for r, g, b in flat.tolist()]
        with open(path, "w") as f:
            f.write("".join(lines))


def read_ppm(path, return_maxval: bool = False):
    """Read P3 or P6 PPM -> [H, W, 3] u8/u16 (optionally with maxval)."""

    def _ret(arr, maxval):
        return (arr, maxval) if return_maxval else arr

    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P6":
        # Parse the three header ints by hand: exactly ONE whitespace byte
        # follows maxval, then the binary payload. (bytes.split would also
        # strip payload pixels whose bytes happen to be whitespace.)
        idx, vals = 2, []
        while len(vals) < 3:
            while data[idx : idx + 1].isspace():
                idx += 1
            start = idx
            while not data[idx : idx + 1].isspace():
                idx += 1
            vals.append(int(data[start:idx]))
        idx += 1  # the single post-maxval whitespace byte
        w, h, maxval = vals
        if maxval > 255:  # 16-bit samples, big-endian (12-bit decodes)
            raw = data[idx : idx + w * h * 6]
            return _ret(np.frombuffer(raw, dtype=">u2").astype(
                np.uint16).reshape(h, w, 3), maxval)
        raw = data[idx : idx + w * h * 3]
        return _ret(np.frombuffer(raw, dtype=np.uint8).reshape(h, w, 3),
                    maxval)
    if data[:2] == b"P3":
        tokens = data.split()
        w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
        dtype = np.uint16 if maxval > 255 else np.uint8
        vals = np.array([int(t) for t in tokens[4 : 4 + w * h * 3]],
                        dtype=dtype)
        return _ret(vals.reshape(h, w, 3), maxval)
    raise ValueError("not a PPM file")
