"""The readers of the ``program_span`` metrics (``benchmark/spans.py``) on a
synthetic trace and span log, their None cases, and the small cells run
traced through the program's recorder."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import run
from benchmark.entries.common import CallRecord
from benchmark.spans import idle_within, traced_spans
from benchmark.trace import Event, Trace
from conftest import CELLS, make_root, run_tiny
from jpeg_tpu_torch.utils import profiling
from jpeg_tpu_torch.utils.profiling import Call, Span

DECODE = ["entropy_wall_ms_per_frame.decode", "host_entropy_ms_per_frame.decode",
          "stack_ms_per_frame.decode", "relayout_d2h_ms_per_frame.decode",
          "idle_entropy_pct.decode", "idle_pixel_pct.decode"]
ENCODE = ["pad_ms_per_frame.encode", "pack_ms_per_frame.encode"]
T0 = 1000 * 10**9  # the anchors' Unix nanoseconds: 1000 s on the trace's clock
MS = 10**6


def _log() -> tuple[list, list]:
    """Two decode calls, the first in the window [1000, 1002] s and the
    second after it, and one encode call at 2000 s."""
    calls = [Call("decode.call", 1, 7, T0, 0),
             Call("decode.call", 90, 7, T0 + 5 * 10**9, 0),
             Call("encode.call", 50, 7, 2 * T0, 0)]
    spans = [Span("decode.call", 1, 1, 0, 7, 0, 2000 * MS,
                  {"frames": 8, "host_frames": 5, "device_frames": 2,
                   "fallback_frames": 1}),
             Span("decode.entropy", 1, 2, 1, 7, 0, 1000 * MS, {}),
             Span("decode.claim", 1, 20, 2, 9, 0, 100 * MS, {})]
    sid = 100
    for j in range(6):  # host and fallback frames: parse 10 ms, entropy 50
        spans += [Span("decode.parse", 1, sid, 2, 8, j * MS, (j + 10) * MS, {}),
                  Span("decode.host_entropy", 1, sid + 1, 2, 8, 0, 50 * MS, {})]
        sid += 2
    for j in range(3):  # the device thread's parse of its claim: left out
        spans.append(Span("decode.parse", 1, sid, 20, 9, 0, 10 * MS, {}))
        sid += 1
    spans += [Span("decode.relayout_d2h", 1, 60, 2, 9, 0, 30 * MS, {}),
              Span("decode.relayout_d2h", 1, 61, 2, 9, 0, 30 * MS, {}),
              Span("decode.pixel", 1, 30, 1, 7, 1000 * MS, 1800 * MS, {}),
              Span("decode.stack", 1, 31, 30, 7, 1000 * MS, 1400 * MS, {}),
              Span("decode.call", 90, 90, 0, 7, 0, 500 * MS, {"frames": 8}),
              Span("decode.stack", 90, 91, 90, 7, 0, 400 * MS, {}),
              Span("encode.call", 50, 50, 0, 7, 0, 90 * MS, {"frames": 1}),
              Span("encode.prepare", 50, 51, 50, 7, 0, 20 * MS, {}),
              Span("encode.pack", 50, 52, 50, 7, 50 * MS, 80 * MS, {})]
    return calls, spans


@pytest.fixture
def log(monkeypatch):
    calls, spans = _log()
    monkeypatch.setattr(profiling, "recorded_calls", lambda: list(calls))
    monkeypatch.setattr(profiling, "recorded_spans", lambda ids=None: [
        s for s in spans if ids is None or s.call in set(ids)])
    return calls, spans


def _decode_trace(window=(1000.0, 1002.0)) -> Trace:
    ev = [Event("bench.call", "cpu", *window),
          Event("k", "kernel", 1000.5, 1000.6),       # in decode.entropy
          Event("Memcpy HtoD", "memcpy", 1001.5, 1001.7),  # in decode.pixel
          Event("Memcpy DtoH", "memcpy", 1001.9, 1002.0)]  # after it
    return Trace(ev, window, [CallRecord(0.0, 2.0, 8, 0)])


def _ctx(root: str, cell: str, tr):
    from benchmark.spec import load_cell

    calls = tr.calls if tr is not None else [CallRecord(0.0, 1.0, 1, 0)]
    return run.Context(load_cell(root, cell), 1.0, 0.0, calls, {}, 10**9, tr)


def _read(root: str, name: str, ctx):
    from benchmark.spec import reader

    return reader(root, name)(ctx)


def test_decode_readers_on_a_synthetic_log(tiny_root, log):
    ctx = _ctx(tiny_root, CELLS[0], _decode_trace())
    got = {n: _read(tiny_root, n, ctx) for n in DECODE}
    assert got == pytest.approx({
        "entropy_wall_ms_per_frame.decode": 1000 / 8,
        "host_entropy_ms_per_frame.decode": 6 * (10 + 50) / 6,
        "stack_ms_per_frame.decode": 400 / 8,   # the second call is not traced
        "relayout_d2h_ms_per_frame.decode": 60 / 2,
        "idle_entropy_pct.decode": 100 * 0.9 / 2,
        "idle_pixel_pct.decode": 100 * 0.6 / 2})
    # with the idle time in the call outside both, they make the device's
    sp = traced_spans(ctx, "decode.call")
    rest = (idle_within(ctx.trace, sp.roots)
            - idle_within(ctx.trace, sp.named("decode.entropy"))
            - idle_within(ctx.trace, sp.named("decode.pixel")))
    assert rest == pytest.approx(0.1)
    idle = _read(tiny_root, "device_idle_pct.decode", ctx)
    assert (got["idle_entropy_pct.decode"] + got["idle_pixel_pct.decode"]
            + 100 * rest / 2) == pytest.approx(idle)
    for n in ENCODE:  # not an encode cell
        assert _read(tiny_root, n, ctx) is None


def test_encode_readers_on_a_synthetic_log(tiny_root, log):
    tr = Trace([Event("bench.call", "cpu", 2000.0, 2000.1)], (2000.0, 2000.1),
               [CallRecord(0.0, 0.1, 1, 0)])
    ctx = _ctx(tiny_root, CELLS[1], tr)
    assert _read(tiny_root, "pad_ms_per_frame.encode", ctx) == pytest.approx(20)
    assert _read(tiny_root, "pack_ms_per_frame.encode", ctx) == pytest.approx(30)
    for n in DECODE:
        assert _read(tiny_root, n, ctx) is None


@pytest.mark.parametrize("case", ["untraced", "no_span_in_window",
                                  "no_recorder"])
def test_readers_give_none(tiny_root, log, monkeypatch, case):
    dec, enc = _decode_trace(), Trace([], (2000.0, 2000.1), [])
    if case == "untraced":
        dec = enc = None
    elif case == "no_span_in_window":
        dec = _decode_trace((3000.0, 3002.0))
        enc = Trace([], (3000.0, 3000.1), [CallRecord(0.0, 0.1, 1, 0)])
    else:  # a program without the recorder, as at the parent commit
        monkeypatch.delattr(profiling, "recorded_calls")
    for cell, names, tr in ((CELLS[0], DECODE, dec), (CELLS[1], ENCODE, enc)):
        ctx = _ctx(tiny_root, cell, tr)
        assert {n: _read(tiny_root, n, ctx) for n in names} == dict.fromkeys(names)


def test_relayout_needs_k3_frames(tiny_root, monkeypatch):
    calls, spans = _log()
    spans[0] = spans[0]._replace(counts=dict(spans[0].counts, device_frames=0))
    monkeypatch.setattr(profiling, "recorded_calls", lambda: calls)
    monkeypatch.setattr(profiling, "recorded_spans", lambda ids=None: [
        s for s in spans if ids is None or s.call in set(ids)])
    ctx = _ctx(tiny_root, CELLS[0], _decode_trace())
    assert _read(tiny_root, "relayout_d2h_ms_per_frame.decode", ctx) is None
    assert _read(tiny_root, "stack_ms_per_frame.decode", ctx) == pytest.approx(50)


def test_small_cells_report_the_span_metrics(tmp_path):
    """Traced runs of the small cells through the program's own recorder
    report every new metric (the relayout's where K3 took a claim in the
    traced calls, which the host workers may leave it no time to do);
    untraced runs report none."""
    root = make_root(str(tmp_path))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    for m in spec["per_layer"]:
        if m["name"] in DECODE + ENCODE:
            m["workloads"] = [CELLS[0] if m["name"] in DECODE else CELLS[1]]
    with open(path, "w") as f:
        json.dump(spec, f)
    for cell, names in ((CELLS[0], DECODE), (CELLS[1], ENCODE)):
        res = run_tiny(root, cell, seconds=2.0, trace=True)
        assert res["correct"]
        got = {n: v["value"] for n, v in res["metrics"].items() if n in names}
        assert set(names) - set(got) <= {"relayout_d2h_ms_per_frame.decode"}
        assert all(v >= 0 for v in got.values())
        assert not set(names) & set(run_tiny(root, cell)["metrics"])
