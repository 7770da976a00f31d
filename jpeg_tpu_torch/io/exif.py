"""Minimal EXIF (APP1) metadata parser.

The reference recognizes no APPn beyond APP0 (and panics on APP12/14,
``src/jpeg/mod.rs:445-450``). Real-world JPEGs carry EXIF in APP1; this
extracts the commonly needed IFD0 tags (orientation, make, model, datetime)
without pulling in a TIFF library. Unknown/garbled payloads yield ``None`` —
metadata never fails a decode.

Copy of ``jpeg_tpu/io/exif.py``.
"""

from __future__ import annotations

import struct

_TAGS = {
    0x0112: "orientation",
    0x010F: "make",
    0x0110: "model",
    0x0132: "datetime",
    0x0131: "software",
}


def parse_exif(payload: bytes) -> dict | None:
    """APP1 body (after the length bytes) -> tag dict, or None."""
    if not payload.startswith(b"Exif\x00\x00"):
        return None
    tiff = payload[6:]
    if len(tiff) < 8:
        return None
    if tiff[:2] == b"II":
        endian = "<"
    elif tiff[:2] == b"MM":
        endian = ">"
    else:
        return None
    try:
        magic, ifd0_off = struct.unpack(endian + "HI", tiff[2:8])
        if magic != 42:
            return None
        out: dict = {}
        (count,) = struct.unpack(endian + "H", tiff[ifd0_off : ifd0_off + 2])
        for i in range(count):
            base = ifd0_off + 2 + i * 12
            tag, typ, n, value_off = struct.unpack(
                endian + "HHII", tiff[base : base + 12]
            )
            name = _TAGS.get(tag)
            if name is None:
                continue
            if typ == 3 and n == 1:  # SHORT
                out[name] = value_off & 0xFFFF if endian == "<" else value_off >> 16
            elif typ == 2:  # ASCII
                raw = (
                    tiff[base + 8 : base + 8 + n]
                    if n <= 4
                    else tiff[value_off : value_off + n]
                )
                out[name] = raw.split(b"\x00")[0].decode("ascii", "replace")
        return out or None
    except (struct.error, IndexError):
        return None
