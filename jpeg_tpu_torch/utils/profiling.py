"""Stage timers, the span recorder and a device trace.

Counterpart of ``jpeg_tpu/utils/profiling.py``. :class:`StageTimer` is a
copy (same report keys); the ``corpus`` command of the CLI writes its
``stages`` report with it. :func:`device_trace` runs ``torch.profiler`` with
CPU and CUDA activities where the JAX package runs ``jax.profiler.trace``,
and writes a Chrome trace (``*.pt.trace.json``) into ``logdir``, the
program's spans included. :func:`queued_ms` times a kernel launch on the
card with CUDA events (the kernel-study tools of
:mod:`jpeg_tpu_torch.tools`).

The span recorder (the port's own; the JAX package has none). A public
entry opens :func:`call`, which records only while a ``torch.profiler``
session is active on the calling thread; otherwise it and every
:func:`span` inside it return a shared no-op context (one thread-local
lookup: no clock read, no allocation, nothing appended). A recorded call
keeps one anchor, ``(time.time_ns(), time.perf_counter_ns())`` read at its
start, through which its spans (``perf_counter_ns``) map onto the
profiler's clock (Unix nanoseconds, the device trace's too). A worker
thread joins the call for one task with ``with adopt(frame):``, ``frame``
being :func:`current` read on the submitting thread; its spans then nest
under the span open there. On the calling thread each span also opens a
``torch.profiler.record_function`` of its name, so the profiler's own
timeline carries the caller's phases. Spans stay in memory, in a
process-wide log of at most :data:`SPAN_LIMIT` (oldest dropped): read them
with :func:`recorded_calls` and :func:`recorded_spans`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import threading
import time
from collections import deque
from typing import NamedTuple


class StageTimer:
    """Accumulates wall-clock per named stage + derived rates."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.meta: dict[str, dict] = {}

    @contextlib.contextmanager
    def stage(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if meta:
                m = self.meta.setdefault(name, {})
                for k, v in meta.items():
                    m[k] = m.get(k, 0) + v

    def report(self) -> dict:
        out = {}
        for name, total in self.totals.items():
            entry = {
                "total_s": round(total, 6),
                "calls": self.counts[name],
                "mean_ms": round(1000 * total / self.counts[name], 3),
            }
            m = self.meta.get(name, {})
            if "bytes" in m and total > 0:
                entry["GB_per_s"] = round(m["bytes"] / total / 1e9, 3)
            if "flops" in m and total > 0:
                entry["GFLOP_per_s"] = round(m["flops"] / total / 1e9, 3)
            if "frames" in m and total > 0:
                entry["frames_per_s"] = round(m["frames"] / total, 2)
            out[name] = entry
        return out

    def dump(self, path=None) -> str:
        s = json.dumps(self.report(), indent=2, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


SPAN_LIMIT = 200_000  # spans kept in the log, oldest dropped
CALL_LIMIT = 20_000   # calls (anchors) kept

_local = threading.local()  # .top: the innermost open span of this thread
_ids = itertools.count(1)   # span ids; a call's id is its root span's
_spans: deque = deque(maxlen=SPAN_LIMIT)
_calls: deque = deque(maxlen=CALL_LIMIT)


class Span(NamedTuple):
    """One recorded span. ``parent`` is 0 for a call's root."""

    name: str
    call: int
    id: int
    parent: int
    thread: int     # threading.get_native_id() of the thread that ran it
    start_ns: int   # time.perf_counter_ns()
    end_ns: int
    counts: dict


class Call(NamedTuple):
    """One recorded call: its root's name and id, the calling thread and
    the anchor read at its start."""

    name: str
    id: int
    thread: int
    unix_ns: int    # time.time_ns()
    perf_ns: int    # time.perf_counter_ns(), read just after

    def to_unix_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` reading of this call on the profiler's
        clock."""
        return perf_ns - self.perf_ns + self.unix_ns


class _Off:
    """The shared no-op span: false, counts nothing."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, key: str, value) -> None:
        pass


_OFF = _Off()


class _Joined:
    """A worker thread's place in a call it adopted: under ``id``."""

    __slots__ = ("call", "id", "mirror")

    def __init__(self, call: Call, span_id: int):
        self.call, self.id, self.mirror = call, span_id, False


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "call", "id", "parent", "mirror", "counts", "start",
                 "prev", "rf")

    def __init__(self, name: str, call: Call, parent: int, mirror: bool):
        self.name, self.call, self.parent, self.mirror = name, call, parent, mirror
        self.id = call.id if parent == 0 else next(_ids)
        self.counts = None
        self.rf = None

    def __bool__(self) -> bool:
        return True

    def add(self, key: str, value) -> None:
        """Add ``value`` to this span's count ``key``."""
        if self.counts is None:
            self.counts = {}
        self.counts[key] = self.counts.get(key, 0) + value

    def __enter__(self):
        # The span holds its mirror: the profiler's first record_function
        # in a process spends ~1 ms after stamping its start.
        self.prev = getattr(_local, "top", None)
        _local.top = self
        self.start = time.perf_counter_ns()
        if self.mirror:
            import torch

            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.perf_counter_ns()
        _local.top = self.prev
        _spans.append(Span(self.name, self.call.id, self.id, self.parent,
                           threading.get_native_id(), self.start, end,
                           self.counts or {}))
        return False


class _Adopt:
    __slots__ = ("frame", "prev")

    def __init__(self, frame):
        self.frame = frame

    def __enter__(self):
        self.prev = getattr(_local, "top", None)
        _local.top = _Joined(self.frame.call, self.frame.id)
        return self

    def __exit__(self, *exc) -> bool:
        _local.top = self.prev
        return False


def _profiler_enabled() -> bool:
    import torch

    return torch._C._autograd._profiler_enabled()


def call(name: str):
    """The root span of a public entry's call: recorded when a
    ``torch.profiler`` session is active on this thread, else the no-op.
    Inside a call already open on this thread it is a span of that call."""
    if getattr(_local, "top", None) is not None:
        return span(name)
    if not _profiler_enabled():
        return _OFF
    unix_ns = time.time_ns()
    c = Call(name, next(_ids), threading.get_native_id(), unix_ns,
             time.perf_counter_ns())
    _calls.append(c)
    return _Open(name, c, 0, True)


def span(name: str):
    """A span of the call open on this thread (or adopted by it), as a
    context manager whose ``add(key, value)`` counts at its boundary; the
    no-op where no call is recorded."""
    top = getattr(_local, "top", None)
    if top is None:
        return _OFF
    return _Open(name, top.call, top.id, top.mirror)


def count(key: str, value) -> None:
    """Add ``value`` to count ``key`` of this thread's innermost open span;
    nothing where none is recorded (for code that opens no span itself,
    such as ``parse_jpeg`` inside ``decode.parse``)."""
    top = getattr(_local, "top", None)
    if isinstance(top, _Open):
        top.add(key, value)


def current():
    """This thread's innermost open span, for :func:`adopt` on another
    thread; None where no call is recorded."""
    return getattr(_local, "top", None)


def adopt(frame):
    """Context in which this thread's spans belong to ``frame``'s call,
    under ``frame`` (from :func:`current`); the no-op for None."""
    return _OFF if frame is None else _Adopt(frame)


def recorded_calls() -> list:
    """The calls in the log, oldest first."""
    return list(_calls)


def recorded_spans(calls=None) -> list:
    """The spans in the log, in the order they ended; of the calls whose
    ids ``calls`` holds, or all."""
    spans = list(_spans)
    if calls is None:
        return spans
    ids = set(calls)
    return [s for s in spans if s.call in ids]


def _chrome_events(calls: list, base_ns: int) -> list:
    """``calls``' spans as Chrome trace complete events on their own
    threads, in microseconds after ``base_ns`` (Unix nanoseconds), with
    call id, span id, parent and counts in ``args``; a thread-name event
    per thread."""
    by_id = {c.id: c for c in calls}
    pid = os.getpid()
    out, threads = [], {}
    for s in recorded_spans(by_id):
        c = by_id[s.call]
        threads.setdefault(s.thread, s.thread == c.thread)
        out.append({"ph": "X", "cat": "jpeg_tpu_torch", "name": s.name,
                    "pid": pid, "tid": s.thread,
                    "ts": (c.to_unix_ns(s.start_ns) - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"call": s.call, "span": s.id,
                             "parent": s.parent, **s.counts}})
    for tid, caller in threads.items():
        out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": f"thread {tid} "
                             f"({'caller' if caller else 'jpeg_tpu_torch'})"}})
    return out


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """``torch.profiler`` trace of the block, CPU and CUDA activities, written
    into ``logdir`` when the block ends as ``tensorboard_trace_handler``
    names it, with the spans of the calls recorded in the block added
    (:func:`_chrome_events`); a no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    since = time.perf_counter_ns()

    def write(prof) -> None:
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                            f"{time.time_ns() // 1_000_000}.pt.trace.json")
        prof.export_chrome_trace(path)
        calls = [c for c in recorded_calls() if c.perf_ns >= since]
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"] += _chrome_events(
            calls, int(trace.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as f:
            json.dump(trace, f)

    with profile(activities=activities, on_trace_ready=write):
        yield


def queued_ms(fn, reps: int) -> float:
    """Median milliseconds of one ``fn()`` over ``reps`` calls queued behind
    ~20 ms of device sleep (so the host's launch time stays out), CUDA
    events around each call. One warm call first."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(40_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))
