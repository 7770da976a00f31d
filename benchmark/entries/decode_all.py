"""``BatchedCorpusDecoder.decode_all``: a closed loop of calls of
``frames_per_call`` distinct frames, bytes in host memory to RGB u8 in host
memory.

Check: a seeded sample of the answers of each entropy route (``host``, and
``device`` where K3 took frames), each held to the reference's decode of
the same bytes. Two numbers are compared, each the worst over the sampled
frames: the share of u8 values that differ from the reference, and the
count of values that differ by more than 1 (rounding moves a value by 1 at
most, so a fault confined to a few blocks shows here).
"""

from __future__ import annotations

import torch

from benchmark.entries.common import CallRecord, Reservoir
from benchmark.inputs import SpliceSource, base_paths, load_base
from benchmark.reference import jpeg as ref


class Entry:
    def __init__(self, cell, seed: int, device: torch.device,
                 decoder_options: dict | None = None):
        from jpeg_tpu_torch.parallel.pipeline import BatchedCorpusDecoder

        self.cfg, self.traffic = cell.config, cell.traffic
        self.n = int(self.traffic["frames_per_call"])
        self.shape = (self.cfg["height"], self.cfg["width"], 3)
        bases = [load_base(p, h) for p, h in base_paths(cell.root, self.cfg)]
        self.source = SpliceSource(bases, seed)
        self.next_frame = 0
        opts = dict(self.traffic["decoder"], **(decoder_options or {}))
        self.decoder = BatchedCorpusDecoder(device=device, **opts)
        self.sample = Reservoir(int(self.traffic["check"]["sample_per_route"]),
                                seed, 2)

    def warm_up(self) -> None:
        """Calls of the window's size: every kernel built and loaded, the
        pools and the allocator in their steady state."""
        for _ in range(int(self.traffic["warmup_calls"])):
            items = self.make_call()
            self.decoder.decode_all(items)

    def make_call(self) -> list:
        items = [self.source.frame(self.next_frame + j) for j in range(self.n)]
        self.next_frame += self.n
        return items

    def call(self, items):
        return self.decoder.decode_all(items)

    def record(self, items, results, t0: float, t1: float) -> CallRecord:
        routes = list(self.decoder.routes)
        failed = abs(len(items) - len(results))
        device_frames, device_scan_bytes = 0, 0
        head = len(self.source.head)
        for j, (item, res) in enumerate(zip(items, results)):
            rgb = getattr(res, "rgb", None)
            if (getattr(res, "error", None) is not None or rgb is None
                    or rgb.shape != self.shape or rgb.dtype.name != "uint8"):
                failed += 1
                continue
            route = routes[j] if j < len(routes) else "host"
            if route == "device":
                device_frames += 1
                device_scan_bytes += len(item) - head
            group = "device" if route == "device" else "host"
            slot = self.sample.offer(group)
            if slot is not None:
                self.sample.put(group, slot, (item, rgb.copy()))
        return CallRecord(t0, t1, len(items), failed,
                          {"device_frames": device_frames,
                           "device_scan_bytes": device_scan_bytes})

    def counters(self) -> dict:
        d = self.decoder
        return {"device_frames": d.device_frames,
                "fallback_frames": d.fallback_frames,
                "entropy_launches": d.entropy_launches,
                "pixel_launches": d.pixel_launches}

    def close(self) -> None:
        self.decoder.close()
        self.decoder = None

    def check(self, device: torch.device) -> tuple[dict, dict]:
        """(numbers compared, what they were read from)."""
        decoder = ref.Decoder()
        worst, over1, by_route = 0.0, 0, {}
        for group, (data, rgb) in self.sample.all():
            frame = ref.parse(data)
            want = ref.pixels(frame, decoder.coefficients(frame), device)
            got = torch.from_numpy(rgb).to(device)
            diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
            worst = max(worst, (diff > 0).sum().item() / want.numel())
            over1 = max(over1, (diff > 1).sum().item())
            by_route[group] = by_route.get(group, 0) + 1
        return {"differ_share": worst, "differ_over1": over1}, {
            "frames_compared": sum(by_route.values()), "by_route": by_route}
