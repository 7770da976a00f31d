"""Inputs from the seed, made from the benchmark's own files only.

Decode: a configuration's base frames are baseline JPEGs with a restart
marker every MCU row, all with the same tables. Restart segments are
independent (T.81 F.2.1.3.1), so a new valid frame is a header and, for
each MCU row, that row's segment from one of the bases, the RST markers
numbered by position. Each frame carries its number in a COM segment, so
that no two frames of a run are the same bytes; the rows are drawn from
the seed, so the scans differ too (``bases ** rows`` choices).

Encode: a pool of photo-like RGB frames drawn on the device with a seeded
``torch.Generator`` (smooth fields of seeded phase and period, plus noise);
each call's frame is a pool frame with the call's number written into its
first pixels, so that no two calls hand over the same pixels.
"""

from __future__ import annotations

import hashlib
import math
import os

import numpy as np
import torch

from benchmark.reference.jpeg import parse


def seed_sequence(seed: int, stream: int) -> np.random.SeedSequence:
    """The run's seed (any whole number) and a stream number."""
    return np.random.SeedSequence([seed % 2**64, stream])


def load_base(path: str, sha256: str) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    got = hashlib.sha256(data).hexdigest()
    if got != sha256:
        raise ValueError(f"{path}: sha256 {got}, the configuration says {sha256}")
    return data


def split_frame(data: bytes) -> tuple[bytes, list[bytes]]:
    """(everything from SOI through the SOS header, the entropy-coded
    segments without their RST markers) of a restart-interval stream."""
    frame = parse(data)
    sos = data.index(b"\xff\xda")
    head = data[:sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")]
    return head, list(frame.segments)


class SpliceSource:
    """Distinct frames of one configuration, drawn from the seed."""

    def __init__(self, bases: list[bytes], seed: int, stream: int = 0):
        parts = [split_frame(b) for b in bases]
        heads = {h for h, _ in parts}
        rows = {len(s) for _, s in parts}
        if len(heads) != 1 or len(rows) != 1:
            raise ValueError("base frames differ in header or segment count")
        self.head = heads.pop()
        self.rows = rows.pop()
        if self.rows < 2:
            raise ValueError("base frames need restart markers")
        last = self.rows - 1
        # pieces[b][j]: row j of base b with the marker that follows it.
        self.pieces = [[seg + (b"\xff" + bytes([0xD0 + j % 8]) if j < last
                               else b"\xff\xd9") for j, seg in enumerate(segs)]
                       for _, segs in parts]
        self.rng = np.random.default_rng(seed_sequence(seed, stream))

    def frame(self, n: int) -> bytes:
        """The ``n``-th frame of this source (call in order of ``n``)."""
        pick = self.rng.integers(0, len(self.pieces), self.rows).tolist()
        tag = f"frame {n}".encode()
        com = b"\xff\xfe" + (len(tag) + 2).to_bytes(2, "big") + tag
        return b"".join([self.head[:2], com, self.head[2:],
                         *(self.pieces[b][j] for j, b in enumerate(pick))])


def stamp(img: np.ndarray, n: int) -> None:
    """Write ``n`` into the first eight pixels of row 0, in place."""
    img[0, :8, :] = np.frombuffer(int(n).to_bytes(8, "little") * 3,
                                  np.uint8).reshape(3, 8).T


def rgb_pool(width: int, height: int, count: int, seed: int,
             device="cpu") -> list[np.ndarray]:
    """``count`` photo-like RGB u8 [height, width, 3] frames from the seed:
    per channel 128 + 80 sin(x / px + a) cos(y / py + b) with seeded
    periods and phases, plus Gaussian noise of 6, clipped."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed_sequence(seed, 1).generate_state(1, np.uint64)[0] >> 1))
    yy = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(width, device=device, dtype=torch.float32)[None, :]
    period = 40.0 + 120.0 * torch.rand((count, 3, 2), generator=g, device=device)
    phase = 2.0 * math.pi * torch.rand((count, 3, 2), generator=g, device=device)
    out = []
    for k in range(count):
        chans = [128.0 + 80.0 * torch.sin(xx / period[k, c, 0] + phase[k, c, 0])
                 * torch.cos(yy / period[k, c, 1] + phase[k, c, 1])
                 for c in range(3)]
        img = torch.stack(chans, -1)
        img += 6.0 * torch.randn(img.shape, generator=g, device=device)
        out.append(img.clamp(0.0, 255.0).to(torch.uint8).cpu().numpy())
    return out


def base_paths(root: str, config: dict) -> list[tuple[str, str]]:
    """(path, sha256) of each base frame a configuration lists."""
    return [(os.path.join(root, b["file"]), b["sha256"])
            for b in config["base_frames"]]
