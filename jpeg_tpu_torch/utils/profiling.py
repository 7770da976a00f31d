"""Stage timers and a device trace.

Counterpart of ``jpeg_tpu/utils/profiling.py``. :class:`StageTimer` is a
copy (same report keys); the ``corpus`` command of the CLI writes its
``stages`` report with it. :func:`device_trace` runs ``torch.profiler`` with
CPU and CUDA activities where the JAX package runs ``jax.profiler.trace``,
and writes a Chrome trace (``*.pt.trace.json``) into ``logdir``.
:func:`queued_ms` times a kernel launch on the card with CUDA events (the
kernel-study tools of :mod:`jpeg_tpu_torch.tools`).
"""

from __future__ import annotations

import contextlib
import json
import time


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


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """``torch.profiler`` trace of the block, CPU and CUDA activities, written
    into ``logdir`` by ``tensorboard_trace_handler`` when the block ends
    (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
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
