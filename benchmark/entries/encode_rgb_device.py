"""``encode_rgb_device``: a closed loop of one-frame calls, RGB u8 in host
memory to JPEG bytes in host memory, each call's frame a pool frame with
the call's number written into it.

Check: a seeded sample of the calls' bytes, read by the reference's parser
and Huffman decoder and held to the reference's forward transform of the
same pixels. Two numbers are compared, each the worst over the sampled
frames: the share of quantised coefficients that differ from the
reference, and the count that differ by more than 1 (rounding moves a
coefficient by 1 at most, so one wrong block shows here).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.entries.common import CallRecord, Reservoir
from benchmark.inputs import rgb_pool, stamp
from benchmark.reference import jpeg as ref


class Entry:
    def __init__(self, cell, seed: int, device: torch.device):
        from jpeg_tpu_torch import encode_rgb_device

        self.cfg, self.traffic = cell.config, cell.traffic
        if int(self.traffic.get("frames_per_call", 1)) != 1:
            raise ValueError("encode_rgb_device takes one frame a call")
        self.device = device
        self.encode = encode_rgb_device
        self.quality = int(self.traffic["quality"])
        self.sampling = tuple(self.cfg["sampling"])
        mcus_x = -(-self.cfg["width"] // (8 * self.sampling[0]))
        self.restart = int(self.traffic["restart_rows"]) * mcus_x
        self.pool = rgb_pool(self.cfg["width"], self.cfg["height"],
                             int(self.traffic["pool"]), seed, device)
        self.next_frame = 0
        self.sample = Reservoir(int(self.traffic["check"]["sample"]), seed, 2)

    def warm_up(self) -> None:
        for _ in range(int(self.traffic["warmup_calls"])):
            self.call(self.make_call())

    def make_call(self):
        n = self.next_frame
        self.next_frame += 1
        img = self.pool[n % len(self.pool)]
        stamp(img, n)
        return n, img

    def call(self, item) -> bytes:
        return self.encode(item[1], quality=self.quality,
                           subsampling=self.sampling,
                           restart_interval_mcus=self.restart,
                           device=self.device)

    def record(self, item, data, t0: float, t1: float) -> CallRecord:
        ok = (isinstance(data, bytes) and data[:2] == b"\xff\xd8"
              and data[-2:] == b"\xff\xd9")
        if ok:
            slot = self.sample.offer("frames")
            if slot is not None:
                self.sample.put("frames", slot, (item[0], data))
        return CallRecord(t0, t1, 1, int(not ok))

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.encode = None

    def source_frame(self, n: int) -> np.ndarray:
        img = self.pool[n % len(self.pool)].copy()
        stamp(img, n)
        return img

    def check(self, device: torch.device) -> tuple[dict, dict]:
        worst, over1, frames = 0.0, 0, 0
        decoder = ref.Decoder()
        for _, (n, data) in self.sample.all():
            want = ref.forward(self.source_frame(n), self.quality,
                               self.sampling, device)
            try:
                frame = ref.parse(data)
                got = decoder.coefficients(frame)
            except (ValueError, IndexError, KeyError):
                share, count = 1.0, _total(want)  # bytes it cannot read
            else:
                share, count = self._differ(frame, got, want)
            worst, over1 = max(worst, share), max(over1, count)
            frames += 1
        return ({"coef_differ_share": worst, "coef_over1": over1},
                {"frames_compared": frames})

    def _differ(self, frame, got: list, want: list) -> tuple[float, int]:
        """(share of coefficients that differ, count that differ by more
        than 1); (1.0, all) where the stream's geometry, sampling, tables
        or restart interval are not the configuration's."""
        h, v = self.sampling
        expect = [(h, v), (1, 1), (1, 1)]
        tables = [ref.scaled_quant(ref.QUANT_LUMA, self.quality),
                  ref.scaled_quant(ref.QUANT_CHROMA, self.quality)]
        if ((frame.width, frame.height) != (self.cfg["width"], self.cfg["height"])
                or [(c.h, c.v) for c in frame.components] != expect
                or frame.restart_interval != self.restart
                or any(not np.array_equal(frame.quant[c.tq], tables[min(i, 1)])
                       for i, c in enumerate(frame.components))):
            return 1.0, _total(want)
        diffs = [(torch.from_numpy(g).to(w.device).to(torch.int32)
                  - w.to(torch.int32)).abs() for g, w in zip(got, want)]
        differ = sum((d > 0).sum().item() for d in diffs)
        return (differ / _total(want),
                sum((d > 1).sum().item() for d in diffs))

    def control_check(self, device: torch.device) -> tuple[dict, dict]:
        """The control: the reference in the program's place, computed in
        bfloat16, judged as the program's answers are."""
        worst, over1, frames = 0.0, 0, 0
        for _, (n, data) in self.sample.all():
            img = self.source_frame(n)
            low = ref.forward(img, self.quality, self.sampling, device,
                              torch.bfloat16)
            want = ref.forward(img, self.quality, self.sampling, device)
            share, count = self._differ(
                ref.parse(data), [x.cpu().numpy() for x in low], want)
            worst, over1 = max(worst, share), max(over1, count)
            frames += 1
        return ({"coef_differ_share": worst, "coef_over1": over1},
                {"frames_compared": frames})


def _total(planes: list) -> int:
    return sum(p.numel() for p in planes)
