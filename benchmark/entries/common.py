"""What every entry shares: the record of a call and a seeded sample."""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.inputs import seed_sequence


@dataclasses.dataclass
class CallRecord:
    t0: float          # host clock, seconds: the call made
    t1: float          # its answers in host memory
    frames: int        # frames handed over
    failed: int        # frames without a sound answer
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Reservoir:
    """A uniform sample of ``k`` items per group, drawn from the seed
    (reservoir sampling): ``offer`` says whether to keep the next item and
    where, so that the caller copies only what is kept."""

    def __init__(self, k: int, seed: int, stream: int):
        self.k = k
        self.rng = np.random.default_rng(seed_sequence(seed, stream))
        self.items: dict = {}
        self.seen: dict = {}

    def offer(self, group: str) -> int | None:
        n = self.seen[group] = self.seen.get(group, 0) + 1
        kept = self.items.setdefault(group, [])
        if len(kept) < self.k:
            kept.append(None)
            return len(kept) - 1
        slot = int(self.rng.integers(0, n))
        return slot if slot < self.k else None

    def put(self, group: str, slot: int, item) -> None:
        self.items[group][slot] = item

    def all(self) -> list:
        return [(g, it) for g in sorted(self.items) for it in self.items[g]]
