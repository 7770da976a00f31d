"""The program's own spans (``jpeg_tpu_torch.utils.profiling``) of the
traced calls, mapped onto the device trace's clock through each call's
anchor, for the readers of the ``program_span`` metrics.

A call is traced when its root span's middle lies in the trace's window.
Where the program has no span recorder, or its log holds no root of the
traced calls, :func:`traced_spans` gives None and the readers report
nothing.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Mapped:
    name: str
    call: int
    id: int
    parent: int
    thread: int
    start: float   # seconds, on the profiler's clock
    end: float
    counts: dict

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class CallSpans:
    spans: list    # Mapped, every span of the traced calls
    roots: list    # Mapped, the traced calls' root spans

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def seconds(self, name: str) -> float:
        return sum(s.dur for s in self.named(name))

    def count(self, key: str) -> int:
        """A count summed over the traced calls' roots."""
        return sum(r.counts.get(key, 0) for r in self.roots)


def traced_spans(ctx, root: str) -> CallSpans | None:
    """The spans of the traced calls whose root is named ``root``."""
    tr = ctx.trace
    if tr is None:
        return None
    try:
        from jpeg_tpu_torch.utils import profiling

        calls = {c.id: c for c in profiling.recorded_calls() if c.name == root}
        log = profiling.recorded_spans(calls)
    except (ImportError, AttributeError):
        return None
    spans = []
    for s in log:
        c = calls[s.call]
        spans.append(Mapped(s.name, s.call, s.id, s.parent, s.thread,
                            c.to_unix_ns(s.start_ns) * 1e-9,
                            c.to_unix_ns(s.end_ns) * 1e-9, s.counts))
    lo, hi = tr.window
    roots = [s for s in spans
             if s.parent == 0 and lo <= (s.start + s.end) / 2 <= hi]
    if not roots:
        return None
    kept = {r.call for r in roots}
    return CallSpans([s for s in spans if s.call in kept], roots)


def union(intervals) -> list:
    """Sorted, merged ``[start, end]`` pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_within(tr, spans) -> float:
    """Seconds of the trace's window in which the device is idle and one of
    ``spans`` is open."""
    lo, hi = tr.window
    inside = union((max(s.start, lo), min(s.end, hi)) for s in spans
                   if s.end > lo and s.start < hi)
    busy = tr.busy_intervals()
    overlap, j = 0.0, 0
    for a, b in inside:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            overlap += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return sum(b - a for a, b in inside) - overlap


def per_frame_ms(ctx, seconds: float) -> float | None:
    frames = sum(c.frames for c in ctx.trace.calls)
    return 1e3 * seconds / frames if frames else None


def idle_pct_in(ctx, entry: str, root: str, name: str) -> float | None:
    """% of the traced window in which the device is idle and the calling
    thread is inside a span ``name``."""
    sp = traced_spans(ctx, root) if ctx.entry == entry else None
    if sp is None:
        return None
    return 100.0 * idle_within(ctx.trace, sp.named(name)) / ctx.trace.window_s
