"""Plain baseline JPEG: a parser, a Huffman decoder, the pixel stage and the
forward transform, written from ITU-T T.81 (the JPEG standard) and JFIF.

The semantics are those of the program's fast path, computed in float64:

- decode: dequantise, the orthonormal 8x8 IDCT, chroma upsampled by
  replication, the JFIF YCbCr -> RGB algebra with G derived from R and B,
  +128, clamp to [0, 255], truncate;
- encode: the JFIF RGB -> YCbCr rows, -128 on Y, edge padding to whole
  MCUs, chroma box mean, the orthonormal forward DCT, division by the
  quantiser, round half to even.

``dtype`` lowers the arithmetic of the forward transform, for the check's
control. Nothing here imports the program or JAX.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

# ZIGZAG[k] is the natural (row-major) index of zigzag position k.
ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
]

# T.81 Annex K tables K.1 and K.2, natural order.
QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
])
QUANT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    *([99] * 32),
])

# JFIF: Y = 0.299 R + 0.587 G + 0.114 B, and the chroma rows.
C_RED, C_GREEN, C_BLUE = 0.299, 0.587, 0.114
RGB_TO_YCC = (
    (C_RED, C_GREEN, C_BLUE),
    (-0.168735892, -0.331264108, 0.5),
    (0.5, -0.418687589, -0.081312411),
)

_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RESTART = re.compile(rb"\xff[\xd0-\xd7]")


def scaled_quant(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG quality scaling of a natural-order table (libjpeg's rule)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def basis() -> np.ndarray:
    """A[u, x] = alpha(u) / 2 * cos((2x + 1) u pi / 16), float64 [8, 8]."""
    u = np.arange(8.0)[:, None]
    x = np.arange(8.0)[None, :]
    alpha = np.where(u == 0, 1.0 / np.sqrt(2.0), 1.0)
    return alpha / 2.0 * np.cos((2.0 * x + 1.0) * u * np.pi / 16.0)


@dataclasses.dataclass
class Component:
    cid: int
    h: int
    v: int
    tq: int
    td: int = 0
    ta: int = 0


@dataclasses.dataclass
class Frame:
    """What a baseline stream says: geometry, tables and its entropy-coded
    restart segments (still byte-stuffed)."""

    width: int
    height: int
    components: list
    quant: dict            # tq -> natural-order int [64]
    dc: dict               # table id -> (code counts, symbols), as DHT says
    ac: dict
    restart_interval: int
    segments: list

    @property
    def h_max(self) -> int:
        return max(c.h for c in self.components)

    @property
    def v_max(self) -> int:
        return max(c.v for c in self.components)

    @property
    def mcus_x(self) -> int:
        return -(-self.width // (8 * self.h_max))

    @property
    def mcus_y(self) -> int:
        return -(-self.height // (8 * self.v_max))

    def slots(self) -> list:
        """(component, row, column) of each block of an MCU, in scan order."""
        if len(self.components) == 1:
            return [(0, 0, 0)]
        return [(ci, dy, dx) for ci, c in enumerate(self.components)
                for dy in range(c.v) for dx in range(c.h)]

    def block_grid(self, ci: int) -> tuple[int, int]:
        c = self.components[ci]
        if len(self.components) == 1:
            return self.mcus_y, self.mcus_x
        return self.mcus_y * c.v, self.mcus_x * c.h


def huffman_lookup(counts, values) -> list:
    """65,536-entry lookup of a canonical Huffman table (T.81 Annex C): the
    16 bits at the cursor -> (code length << 8) | symbol; 0 for no code."""
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            entry = (length << 8) | values[k]
            lut[lo:hi] = [entry] * (hi - lo)
            code += 1
            k += 1
        code <<= 1
    return lut


def parse(data: bytes) -> Frame:
    """Read a baseline (SOF0/SOF1, 8-bit, Huffman) interleaved stream."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("no SOI")
    pos, quant, dc, ac, restart, frame = 2, {}, {}, {}, 0, None
    while True:
        if data[pos] != 0xFF:
            raise ValueError(f"no marker at byte {pos}")
        marker = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        body = data[pos + 4:pos + 2 + length]
        if marker in (0xC0, 0xC1):
            if body[0] != 8:
                raise ValueError("not 8-bit")
            comps = [Component(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                               body[7 + 3 * i] & 15, body[8 + 3 * i])
                     for i in range(body[5])]
            frame = (int.from_bytes(body[3:5], "big"),
                     int.from_bytes(body[1:3], "big"), comps)
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"not baseline Huffman (SOF 0x{marker:02X})")
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                if body[i] >> 4:
                    raise ValueError("16-bit quantiser")
                zz = np.frombuffer(body[i + 1:i + 65], np.uint8).astype(np.int64)
                nat = np.zeros(64, np.int64)
                nat[ZIGZAG] = zz
                quant[body[i] & 15] = nat
                i += 65
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                n = sum(body[i + 1:i + 17])
                (ac if body[i] >> 4 else dc)[body[i] & 15] = (
                    bytes(body[i + 1:i + 17]), bytes(body[i + 17:i + 17 + n]))
                i += 17 + n
        elif marker == 0xDD:
            restart = int.from_bytes(body[:2], "big")
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("SOS before SOF")
            width, height, comps = frame
            by_id = {c.cid: c for c in comps}
            if body[0] != len(comps):
                raise ValueError("scan does not hold every component")
            for i in range(body[0]):
                c = by_id[body[1 + 2 * i]]
                c.td, c.ta = body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15
            start = pos + 2 + length
            end = _SCAN_END.search(data, start)
            if end is None:
                raise ValueError("no end of scan")
            return Frame(width, height, comps, quant, dc, ac, restart,
                         _RESTART.split(data[start:end.start()]))
        pos += 2 + length


def decode_segment(seg: bytes, n_mcus: int, tables: list) -> np.ndarray:
    """Huffman-decode one restart segment: ``n_mcus`` MCUs whose blocks use
    ``tables[slot] = (component, dc lookup, ac lookup)``. Returns int32
    [n_mcus, len(tables), 64], natural order, DC prediction applied (reset
    at the segment's start)."""
    buf = seg.replace(b"\xff\x00", b"\xff") + bytes(8)
    b = np.frombuffer(buf, np.uint8).astype(np.int64)
    win = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
    nat = ZIGZAG
    idx, vals = [], []
    add_i, add_v = idx.append, vals.append
    pred = [0] * 4
    pos = 0
    base = 0
    for _ in range(n_mcus):
        for ci, dcl, acl in tables:
            e = dcl[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e:
                raise ValueError("invalid DC code")
            pos += e >> 8
            s = e & 0xFF
            if s:
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                pred[ci] += v
            add_i(base)
            add_v(pred[ci])
            k = 1
            while k < 64:
                e = acl[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e:
                    raise ValueError("invalid AC code")
                pos += e >> 8
                s = e & 15
                if not s:
                    if e & 0xF0 == 0xF0:  # ZRL
                        k += 16
                        continue
                    break  # EOB
                k += (e >> 4) & 15
                if k > 63:
                    raise ValueError("AC run past the block")
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                add_i(base + nat[k])
                add_v(v)
                k += 1
            base += 64
    if (pos + 7) >> 3 > len(buf) - 8:
        raise ValueError("segment ends inside a block")
    out = np.zeros(n_mcus * len(tables) * 64, np.int32)
    out[np.asarray(idx, np.int64)] = vals
    return out.reshape(n_mcus, len(tables), 64)


class Decoder:
    """Coefficients of baseline streams. Restart segments are independent
    (T.81 F.2.1.3.1: byte-aligned, DC predictions reset), so a segment
    decoded once is kept by its bytes and tables and not decoded again."""

    def __init__(self):
        self._memo: dict = {}
        self._luts: dict = {}

    def _lut(self, table: tuple) -> list:
        if table not in self._luts:
            self._luts[table] = huffman_lookup(list(table[0]), list(table[1]))
        return self._luts[table]

    def coefficients(self, frame: Frame) -> list[np.ndarray]:
        """Per component int32 [block rows, block columns, 64], natural
        order."""
        slots = frame.slots()
        raw = [(ci, frame.dc[frame.components[ci].td],
                frame.ac[frame.components[ci].ta]) for ci, _, _ in slots]
        sig = tuple(raw)
        tables = [(ci, self._lut(d), self._lut(a)) for ci, d, a in raw]
        n_mcus = frame.mcus_x * frame.mcus_y
        per_seg = frame.restart_interval or n_mcus
        if -(-n_mcus // per_seg) != len(frame.segments):
            raise ValueError(f"{len(frame.segments)} segments for {n_mcus} "
                             f"MCUs at {per_seg} a segment")
        out = [np.zeros((*frame.block_grid(ci), 64), np.int32)
               for ci in range(len(frame.components))]
        for si, seg in enumerate(frame.segments):
            m0 = si * per_seg
            n = min(per_seg, n_mcus - m0)
            key = (sig, n, seg)
            blocks = self._memo.get(key)
            if blocks is None:
                blocks = self._memo[key] = decode_segment(seg, n, tables)
            ms = np.arange(m0, m0 + n)
            my, mx = ms // frame.mcus_x, ms % frame.mcus_x
            for s, (ci, dy, dx) in enumerate(slots):
                c = frame.components[ci]
                hh, vv = (1, 1) if len(slots) == 1 else (c.h, c.v)
                out[ci][my * vv + dy, mx * hh + dx] = blocks[:, s]
        return out


def _blocks_to_plane(x: torch.Tensor) -> torch.Tensor:
    r, c = x.shape[:2]
    return x.permute(0, 2, 1, 3).reshape(r * 8, c * 8)


def _plane_to_blocks(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    return x.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)


def pixels(frame: Frame, coeffs: list, device="cpu") -> torch.Tensor:
    """RGB u8 [H, W, 3] of decoded coefficients, in float64."""
    a = torch.from_numpy(basis()).to(device)
    planes = []
    for ci, c in enumerate(frame.components):
        f = torch.from_numpy(coeffs[ci]).to(device, torch.float64)
        q = torch.from_numpy(frame.quant[c.tq]).to(device, torch.float64)
        f = (f * q).view(*f.shape[:2], 8, 8)
        s = _blocks_to_plane(torch.einsum("vy,rcvu,ux->rcyx", a, f, a))
        if len(frame.components) > 1:
            s = s.repeat_interleave(frame.v_max // c.v, 0).repeat_interleave(
                frame.h_max // c.h, 1)
        planes.append(s[:frame.height, :frame.width])
    if len(planes) == 1:
        rgb = torch.stack([planes[0]] * 3, -1)
    else:
        y, cb, cr = planes
        r = y + (2.0 - 2.0 * C_RED) * cr
        b = y + (2.0 - 2.0 * C_BLUE) * cb
        g = (y - C_BLUE * b - C_RED * r) / C_GREEN
        rgb = torch.stack([r, g, b], -1)
    return torch.floor((rgb + 128.0).clamp(0.0, 255.0)).to(torch.uint8)


def forward(rgb: np.ndarray, quality: int, sampling: tuple[int, int],
            device="cpu", dtype=torch.float64) -> list[torch.Tensor]:
    """Quantised coefficients of an RGB u8 [H, W, 3] image as a baseline
    encoder with IJG tables at ``quality`` and luma sampling ``sampling``
    (chroma 1x1) writes them: per component int32 [block rows, block
    columns, 64], natural order, on ``device``, computed in ``dtype``."""
    h_s, v_s = sampling
    height, width = rgb.shape[:2]
    rows = -(-height // (8 * v_s)) * 8 * v_s
    cols = -(-width // (8 * h_s)) * 8 * h_s
    x = torch.from_numpy(np.ascontiguousarray(rgb)).to(device).to(dtype)
    x = torch.nn.functional.pad(x.permute(2, 0, 1)[None],
                                (0, cols - width, 0, rows - height),
                                mode="replicate")[0]
    a = torch.from_numpy(basis()).to(device, dtype)
    out = []
    for ci, (kr, kg, kb) in enumerate(RGB_TO_YCC):
        p = kr * x[0] + kg * x[1] + kb * x[2]
        if ci == 0:
            p = p - 128.0
        else:
            p = p.view(rows // v_s, v_s, cols // h_s, h_s).mean((1, 3))
        g = _plane_to_blocks(p)
        coef = torch.einsum("uy,rcyx,vx->rcuv", a, g, a)
        base = QUANT_LUMA if ci == 0 else QUANT_CHROMA
        q = torch.from_numpy(scaled_quant(base, quality)).to(device, dtype)
        qz = torch.round(coef.reshape(*coef.shape[:2], 64) / q)
        out.append(qz.to(torch.int32))
    return out
