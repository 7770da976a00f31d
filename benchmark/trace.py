"""The device trace of a few calls, by ``torch.profiler`` (CUPTI), reduced
in memory: no trace file is written.

Each traced call sits in a ``bench.call`` span of the benchmark's own. The
traced window runs from the first such span's start to the last one's end.
Device events are kernels, memory copies and memsets; their union over the
window is the time the device was busy.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

CALL_SPAN = "bench.call"


@dataclasses.dataclass
class Event:
    name: str
    kind: str      # "kernel", "memcpy", "memset" or "cpu"
    start: float   # seconds, on the profiler's clock
    end: float
    thread: int = 0

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Trace:
    events: list          # Event, device and host
    window: tuple         # (start, end) seconds of the traced calls
    calls: list           # the call records traced, in order

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def device(self, kind: str | None = None) -> list:
        """Device events inside the window (clipped), of ``kind`` or all."""
        lo, hi = self.window
        return [dataclasses.replace(e, start=max(e.start, lo), end=min(e.end, hi))
                for e in self.events
                if e.kind != "cpu" and (kind is None or e.kind == kind)
                and e.end > lo and e.start < hi]

    def busy_intervals(self) -> list:
        """The union of the device events in the window, merged."""
        out = []
        for e in sorted(self.device(), key=lambda e: e.start):
            if out and e.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e.end)
            else:
                out.append([e.start, e.end])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_s(self, match) -> float | None:
        """Summed time of the kernels whose name ``match`` accepts; None if
        the trace holds none."""
        ks = [e.dur for e in self.device("kernel") if match(e.name)]
        return sum(ks) if ks else None


def _kind(name: str, on_device: bool) -> str:
    if not on_device:
        return "cpu"
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def events_of(prof) -> list:
    """Every event of a finished ``torch.profiler.profile``."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and (e.is_user_annotation()
                                        or e.name() == CALL_SPAN):
            continue  # a host span's shadow on the device's timeline
        start = e.start_ns() * 1e-9
        out.append(Event(e.name(), _kind(e.name(), e.device_type() == cuda),
                         start, start + e.duration_ns() * 1e-9,
                         e.start_thread_id()))
    return out


def reduce(events: list, calls: list) -> Trace:
    spans = [e for e in events if e.kind == "cpu" and e.name == CALL_SPAN]
    if not spans:
        raise RuntimeError("the trace holds no call span")
    return Trace(events, (min(e.start for e in spans), max(e.end for e in spans)),
                 calls)


class Tracer:
    """Profiles the calls made between :meth:`start` and :meth:`stop`."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._calls: list = []
        self.trace: Trace | None = None

    def start(self) -> None:
        self._prof.__enter__()

    @contextlib.contextmanager
    def call(self):
        with torch.profiler.record_function(CALL_SPAN):
            yield

    def add(self, record) -> None:
        self._calls.append(record)

    def stop(self) -> None:
        self._prof.__exit__(None, None, None)
        self.trace = reduce(events_of(self._prof), self._calls)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the window, and the
    longest idle gaps, each named by the device operations on either side
    and the host's innermost torch operation at the gap's middle (or the
    call span alone: Python and NumPy work of the program)."""
    by_name: dict = {}
    for e in tr.device():
        by_name[e.name] = by_name.get(e.name, 0.0) + e.dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = tr.busy_intervals()
    lo, hi = tr.window
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    dev = sorted(tr.device(), key=lambda e: e.start)
    host = [e for e in tr.events if e.kind == "cpu"]
    named = []
    for a, b in gaps:
        before = [e.name for e in dev if e.end <= a]
        after = [e.name for e in dev if e.start >= b]
        mid = (a + b) / 2
        inner = [e for e in host if e.start <= mid <= e.end]
        what = min(inner, key=lambda e: e.dur).name if inner else "no span"
        named.append([f"{_short(before[-1]) if before else 'start'} -> "
                      f"{_short(after[0]) if after else 'end'} | host: "
                      f"{_short(what)}", b - a])
    return {"device_ops": [[_short(n, 120), s] for n, s in ops],
            "idle_gaps": named}


def _short(name: str, n: int = 48) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."
