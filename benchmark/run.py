"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, inputs from the seed, the program's builds at the first
run in a checkout, warm-up calls of the window's own shapes) is timed as
``setup_s``. Then a closed loop of calls runs for ``--seconds``; a call
counts if its answers are in host memory before the window ends. With
``--trace 1`` a few calls of the window are profiled and the per-layer
metrics are reported; with ``--trace 0`` the end-to-end ones. After the
window the program's state is freed and a seeded sample of its answers is
held to ``benchmark.reference``.

Earlier lines (stderr) say what ran; the last lines of stderr are the
numbers compared, each beside its limit; the last line of stdout is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown`` when traced), then ``check``, the numbers
compared with their limits. Exits non-zero, printing no result, without a
CUDA device, with fewer than the cell's chips, or when JAX or the JAX
package was imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "jpeg_tpu")
PROGRAM = "jpeg_tpu_torch"
# The checkout that holds this harness; the program must come from it.
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class RunError(RuntimeError):
    """A run that must print no result."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Context:
    """What a metric reader may read."""

    cell: object          # spec.Cell
    setup_s: float
    window_start: float
    calls: list           # CallRecord of the calls completed in the window
    counters: dict        # the program's counters over the window
    peak_rss_bytes: int
    trace: object | None  # trace.Trace of the profiled calls

    @property
    def entry(self) -> str:
        return self.cell.traffic["entry"]

    @property
    def frames(self) -> int:
        return sum(c.frames for c in self.calls)


class RssPeak:
    """The process's peak resident set from :meth:`start` on: ``VmRSS``
    sampled every 10 ms. (``VmHWM`` cannot serve where a gVisor sandbox
    refuses its reset through ``/proc/self/clear_refs``: it would hold
    set-up's peak.)"""

    def __init__(self):
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._max = 0

    @staticmethod
    def rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        raise RunError("no VmRSS in /proc/self/status")

    def start(self) -> None:
        self._max = self.rss()
        self._thread.start()

    def _sample(self) -> None:
        while not self._stop.wait(0.01):
            self._max = max(self._max, self.rss())

    def peak(self) -> int:
        self._stop.set()
        self._thread.join()
        return max(self._max, self.rss())


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def refuse_forbidden() -> None:
    """Raise RunError if JAX or the JAX package is loaded in this process."""
    found = forbidden_modules()
    if found:
        raise RunError(f"modules loaded in this process: {found}")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def window(entry, seconds: float, tracer, traced: range):
    """The closed loop: calls back to back until ``seconds`` have passed,
    the calls numbered ``traced`` profiled by ``tracer``. Returns (its
    start, the records of the calls completed in it, of every call made)."""
    calls, made = [], []
    start = time.perf_counter()
    end = start + seconds
    i = 0
    while time.perf_counter() < end:
        if tracer is not None and i == traced.start:
            tracer.start()
        args = entry.make_call()
        with tracer.call() if i in traced else contextlib.nullcontext():
            t0 = time.perf_counter()
            out = entry.call(args)
            t1 = time.perf_counter()
        rec = entry.record(args, out, t0, t1)
        del out, args
        made.append(rec)
        if i in traced:
            tracer.add(rec)
            if i == traced[-1]:
                tracer.stop()
        if t1 <= end:
            calls.append(rec)
        i += 1
    if tracer is not None and tracer.trace is None:
        if i <= traced.start:
            raise RunError("the window ended before a call was traced")
        tracer.stop()
    return start, calls, made


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, entry_options: dict | None = None,
             judge: str = "check") -> dict:
    """One run of ``cell``; returns the result object (without printing).
    ``entry_options`` and ``judge`` (the entry's method that reads the
    numbers compared) are the control's (``benchmark.control``)."""
    import torch

    from benchmark import spec
    from benchmark.trace import Tracer, breakdown

    traffic = cell.traffic
    mod = importlib.import_module(f"benchmark.entries.{traffic['entry']}")
    entry = mod.Entry(cell, seed, device, **(entry_options or {}))
    entry.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    tracer = Tracer(device) if trace else None
    traced = range(1, 1 + int(traffic["trace_calls"])) if trace else range(0)
    rss = RssPeak()
    before = entry.counters()
    rss.start()
    start, calls, made = window(entry, seconds, tracer, traced)
    peak_rss = rss.peak()
    after = entry.counters()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    refuse_forbidden()
    if not calls:
        raise RunError("no call completed in the window")

    ctx = Context(cell, setup_s, start, calls,
                  {k: after[k] - before[k] for k in after}, peak_rss,
                  tracer.trace if trace else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(cell.root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    extra = {}
    if trace:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.window_s
        extra["breakdown"] = breakdown(ctx.trace)
    log(f"window {seconds} s: {len(calls)} calls completed, {len(made)} made; "
        f"program counters over the window {ctx.counters}")

    entry.close()
    del tracer, ctx
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, seen = getattr(entry, judge)(device)
    log(f"check {time.perf_counter() - t_check:.1f} s over {seen}")
    limits = traffic["limits"]
    failed = sum(r.failed for r in made)
    compared = {"failed": {"value": failed, "limit": 0}}
    compared.update({k: {"value": v, "limit": limits[k]}
                     for k, v in numbers.items()})
    correct = (seen["frames_compared"] > 0
               and all(c["value"] <= c["limit"] for c in compared.values()))
    return {"correct": correct, "attempted": sum(r.frames for r in made),
            "failed": failed, "metrics": metrics, "device": dev, **extra,
            "check": compared}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(result: dict) -> None:
    """The numbers compared as the last lines of stderr, then the result
    as the last line of stdout."""
    for name, c in result["check"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    root = os.getcwd()
    import torch

    from benchmark.spec import load_cell

    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is False")
        return 2
    cell = load_cell(root, args.workload)
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} devices, "
            f"{torch.cuda.device_count()} visible")
        return 2
    program = importlib.import_module(PROGRAM)
    if not os.path.abspath(program.__file__).startswith(CHECKOUT + os.sep):
        log(f"{PROGRAM} comes from {program.__file__}, outside {CHECKOUT}")
        return 2
    from jpeg_tpu_torch import runtime

    log(f"cell {cell.name}: config {cell.config['name']}, traffic "
        f"{json.dumps({k: v for k, v in cell.traffic.items() if k != 'limits'})}")
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; host cores {os.cpu_count()}")
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
        log(f"C++ runtime: pgo {runtime.pgo_status()}; chunk tuner "
            f"consulted: {bool(runtime.spec_tuner_snapshot())} "
            f"(snapshot {runtime.spec_tuner_snapshot()})")
        refuse_forbidden()  # the check and the lines above ran after the window
    except RunError as e:
        log(f"run refused: {e}")
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
