"""The span recorder of ``jpeg_tpu_torch.utils.profiling`` in
``BatchedCorpusDecoder.decode_all`` and ``encode_rgb_device``: nothing is
recorded without a profiler, a profiled call's spans cover every thread,
nest, carry the call's counts, map onto the profiler's clock, and land in
``device_trace``'s Chrome trace. Imports no JAX: the ``cuda`` test runs on
the card with

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

from __future__ import annotations

import json
import os
import threading
import types

import pytest
import torch

from jpeg_tpu_torch import BatchedCorpusDecoder, encode_rgb, encode_rgb_device
from jpeg_tpu_torch.io.corpus import synthetic_image
from jpeg_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = [torch.profiler.ProfilerActivity.CPU]
DECODE_SPANS = {"decode.call", "decode.entropy", "decode.parse",
                "decode.host_entropy", "decode.claim", "decode.k3_prepare",
                "decode.k3_launch", "decode.k3_wait", "decode.relayout_d2h",
                "decode.pixel", "decode.stack", "decode.k1",
                "decode.crop_d2h"}


def _corpus(n, **enc):
    enc = dict(dict(quality=85, subsampling=(2, 2), restart_interval_mcus=3),
               **enc)
    return [encode_rgb(synthetic_image(96, 64, i), **enc) for i in range(n)]


CORPORA = {
    "plain": lambda: _corpus(24),
    # a claim whose Huffman tables differ goes back to the host (fallback)
    "mixed_tables": lambda: _corpus(12) + _corpus(2, optimize=True),
}


def _decoder():
    return BatchedCorpusDecoder(workers=2, hybrid_device=True, device_batch=2,
                                device="cpu")


def _new_calls(before: list) -> list:
    seen = {c.id for c in before}
    return [c for c in profiling.recorded_calls() if c.id not in seen]


def test_off_records_nothing(monkeypatch):
    """No profiler: no span, no call, no clock read, no record_function."""
    items, dec = _corpus(24), _decoder()
    dec.decode_all(items)  # pools up
    spans, calls = profiling.recorded_spans(), profiling.recorded_calls()

    def boom(*_a, **_k):
        raise AssertionError("read or opened with the profiler off")

    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter_ns=boom, time_ns=boom))
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert all(r.ok for r in dec.decode_all(items))
    assert dec.device_frames > 0
    encode_rgb_device(synthetic_image(96, 64, 1), device="cpu")
    assert profiling.recorded_spans() == spans
    assert profiling.recorded_calls() == calls
    assert not profiling.span("x") and profiling.current() is None


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_profiled_decode_records_every_thread(corpus):
    items, dec = CORPORA[corpus](), _decoder()
    before = profiling.recorded_calls()
    fallback = dec.fallback_frames
    with torch.profiler.profile(activities=CPU):
        results = dec.decode_all(items)
    assert all(r.ok for r in results)
    (call,) = _new_calls(before)
    spans = profiling.recorded_spans([call.id])
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.parent == 0]
    assert root.name == call.name == "decode.call" and root.id == call.id
    assert root.thread == call.thread == threading.get_native_id()
    names = {s.name for s in spans}
    assert names <= DECODE_SPANS and "decode.claim" in names
    assert len({s.thread for s in spans}) >= 2
    assert all(s.call == call.id for s in spans)
    for s in spans:
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
    c = root.counts
    assert c["frames"] == len(items)
    assert c["host_frames"] + c["device_frames"] + c["fallback_frames"] == c["frames"]
    assert c["fallback_frames"] == dec.fallback_frames - fallback
    assert c["k1_launches"] == c["buckets"] == 1
    assert c["compat_frames"] == c["error_frames"] == 0
    # a fresh decoder makes its staging buffer in this call: no frame had
    # a slot yet, and there is no card to page-lock it for
    assert c["staged_frames"] == c["pinned_frames"] == 0
    (stack,) = [s for s in spans if s.name == "decode.stack"]
    assert stack.counts["bytes"] > 0
    if corpus == "plain":  # K3 takes claims
        assert names == DECODE_SPANS
        assert c["device_frames"] > 0 and c["k3_launches"] > 0
    else:
        assert c["fallback_frames"] >= 2
    # one parse a frame, and a second for a frame claimed then sent back
    parse = [s for s in spans if s.name == "decode.parse"]
    assert len(parse) == c["frames"] + c["fallback_frames"]
    routes = [s.counts for s in spans if s.name == "decode.host_entropy"]
    assert sum(r.get("fallback", 0) for r in routes) == c["fallback_frames"]
    assert sum(r.get("host", 0) for r in routes) == c["host_frames"]
    relayout = [s for s in spans if s.name == "decode.relayout_d2h"]
    assert len(relayout) == c["device_frames"]
    # the workers' and the device thread's spans nest under the caller's
    # decode.entropy
    for s in spans:
        p = s
        while p.thread != call.thread:
            p = by_id[p.parent]
        if p is not s:
            assert p.name == "decode.entropy"


def test_profiled_warm_decode_counts_its_staging():
    """A second call of the same size: every frame went straight into its
    staging slot, so ``decode.stack`` copies only the quantisation
    tables."""
    items, dec = _corpus(24), _decoder()
    dec.decode_all(items)
    before = profiling.recorded_calls()
    with torch.profiler.profile(activities=CPU):
        assert all(r.ok for r in dec.decode_all(items))
    (call,) = _new_calls(before)
    spans = profiling.recorded_spans([call.id])
    (root,) = [s for s in spans if s.parent == 0]
    assert root.counts["staged_frames"] == root.counts["frames"] == 24
    assert root.counts["pinned_frames"] == 0
    (stack,) = [s for s in spans if s.name == "decode.stack"]
    assert stack.counts["bytes"] == 24 * 3 * 64 * 4  # [24, 3, 64] float32
    dec.close()


def test_profiled_decode_counts_its_result_download():
    """``decode.crop_d2h`` counts the bytes that came down and those that
    went into page-locked memory (none without a card); ``decode.call``
    counts the frames whose RGB did (``pinned_rgb_frames``)."""
    items, dec = _corpus(24), _decoder()
    dec.decode_all(items)
    before = profiling.recorded_calls()
    with torch.profiler.profile(activities=CPU):
        results = dec.decode_all(items)
    (call,) = _new_calls(before)
    spans = profiling.recorded_spans([call.id])
    (root,) = [s for s in spans if s.parent == 0]
    assert root.counts["pinned_rgb_frames"] == dec.pinned_rgb_frames == 0
    (crop,) = [s for s in spans if s.name == "decode.crop_d2h"]
    assert crop.counts == {"bytes": 24 * 64 * 96 * 3, "pinned_bytes": 0}
    assert sum(r.rgb.nbytes for r in results) == crop.counts["bytes"]
    dec.close()


def test_profiled_decode_counts_its_shared_tables():
    """Each ``decode.parse`` counts the DHT tables it read (``tables``) and
    those the table cache already held (``tables_reused``): from an empty
    cache every distinct table is built at least once, in the next call
    none is; the benchmark's ``table_reuse_share.decode`` reads the
    second call's share."""
    from benchmark.spec import reader
    from jpeg_tpu_torch.entropy import tables

    items, dec = _corpus(24), _decoder()
    shares = []
    tables.TABLES.clear()
    for _ in range(2):
        before = profiling.recorded_calls()
        with torch.profiler.profile(activities=CPU):
            assert all(r.ok for r in dec.decode_all(items))
        (call,) = _new_calls(before)
        spans = profiling.recorded_spans([call.id])
        parse = [s for s in spans if s.name == "decode.parse"]
        assert parse and all(s.counts["tables"] == 4 for s in parse)
        (root,) = [s for s in spans if s.parent == 0]
        window = (call.to_unix_ns(root.start_ns) * 1e-9,
                  call.to_unix_ns(root.end_ns) * 1e-9)
        ctx = types.SimpleNamespace(entry="decode_all",
                                    trace=types.SimpleNamespace(window=window))
        shares.append(reader(ROOT, "table_reuse_share.decode")(ctx))
        reused = sum(s.counts["tables_reused"] for s in parse)
        assert reused <= 4 * len(parse) - (4 if len(shares) == 1 else 0)
    assert shares[0] < 100.0 == shares[1]
    dec.close()


def test_profiled_encode_records_its_phases():
    img = synthetic_image(96, 64, 2)
    before = profiling.recorded_calls()
    with torch.profiler.profile(activities=CPU):
        data = encode_rgb_device(img, device="cpu")
    (call,) = _new_calls(before)
    spans = profiling.recorded_spans([call.id])
    root = next(s for s in spans if s.parent == 0)
    assert root.name == "encode.call"
    assert root.counts == {"frames": 1, "bytes_in": img.nbytes,
                           "bytes_out": len(data)}
    kids = sorted((s for s in spans if s.parent == root.id),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["encode.prepare", "encode.k2",
                                      "encode.d2h", "encode.pack"]
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
               for s in kids)


@pytest.mark.parametrize("card", [
    "emulated", pytest.param("real", marks=pytest.mark.cuda)])
def test_profiled_card_encode_records_its_upload(monkeypatch, card):
    """The card route records ``encode.upload`` (the frame's upload and
    its layout) between ``encode.prepare`` and ``encode.k2``, counting the
    frame's ``bytes``, and ``upload_ms_per_frame.encode`` reads its wall a
    frame; the CPU route has no such span, and the reader gives nothing.
    ``emulated`` runs the card route here, its upload and K2 on the CPU."""
    from benchmark.spec import reader
    from jpeg_tpu_torch.models import encoder
    from jpeg_tpu_torch.parallel import batch

    if card == "real" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    if card == "emulated":
        real_k2 = batch.encode_batch_device
        monkeypatch.setattr(encoder, "upload_frame",
                            lambda rgb, device: torch.from_numpy(rgb))
        monkeypatch.setattr(batch, "encode_batch_device",
                            lambda *a, device, **kw: real_k2(*a, device="cpu",
                                                             **kw))
    read = reader(ROOT, "upload_ms_per_frame.encode")
    img = synthetic_image(96, 64, 4)
    got = {}
    for device in ("cuda", "cpu"):
        encode_rgb_device(img, device=device)  # builds and warms up
        before = profiling.recorded_calls()
        with torch.profiler.profile(activities=CPU):
            data = encode_rgb_device(img, device=device)
        (call,) = _new_calls(before)
        spans = profiling.recorded_spans([call.id])
        root = next(s for s in spans if s.parent == 0)
        kids = sorted((s for s in spans if s.parent == root.id),
                      key=lambda s: s.start_ns)
        window = (call.to_unix_ns(root.start_ns) * 1e-9,
                  call.to_unix_ns(root.end_ns) * 1e-9)
        ctx = types.SimpleNamespace(entry="encode_rgb_device",
                                    trace=types.SimpleNamespace(
                                        window=window,
                                        calls=[types.SimpleNamespace(frames=1)]))
        got[device] = data, kids, read(ctx)
    (data, kids, ms), (want, cpu_kids, cpu_ms) = got["cuda"], got["cpu"]
    assert data == want
    assert [s.name for s in kids] == ["encode.prepare", "encode.upload",
                                      "encode.k2", "encode.pack"]
    assert kids[1].counts == {"bytes": img.nbytes}
    # the reader's times pass through the anchor's Unix seconds
    assert ms == pytest.approx(1e-6 * (kids[1].end_ns - kids[1].start_ns),
                               abs=1e-3)
    assert ms > 0
    assert "encode.upload" not in [s.name for s in cpu_kids]
    assert cpu_ms is None


def test_calls_map_onto_the_profilers_clock():
    """Each root, mapped through its call's anchor, lies within 1 ms of
    the record_function the call mirrors on the profiler's timeline."""
    items, dec = _corpus(24), _decoder()
    before = profiling.recorded_calls()
    with torch.profiler.profile(activities=CPU) as prof:
        dec.decode_all(items)
        dec.decode_all(items)
        encode_rgb_device(synthetic_image(96, 64, 3), device="cpu")
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in ("decode.call", "encode.call")]
    calls = _new_calls(before)
    assert [c.name for c in calls] == [e.name() for e in events] == [
        "decode.call", "decode.call", "encode.call"]
    for c, e in zip(calls, events):
        root = next(s for s in profiling.recorded_spans([c.id]) if s.parent == 0)
        assert abs(c.to_unix_ns(root.start_ns) - e.start_ns()) < 1_000_000
        assert abs(c.to_unix_ns(root.end_ns) - e.end_ns()) < 1_000_000


def test_log_keeps_its_bound():
    before = profiling.recorded_calls()
    with torch.profiler.profile(activities=CPU):
        with profiling.call("bound") as root:
            frame = profiling.current()

            def work():
                with profiling.adopt(frame):
                    for _ in range(profiling.SPAN_LIMIT + 10):
                        with profiling.span("tick"):
                            pass

            t = threading.Thread(target=work)
            t.start()
            t.join()
    (call,) = _new_calls(before)
    spans = profiling.recorded_spans()
    assert len(spans) == profiling.SPAN_LIMIT
    assert spans[-1].id == root.id  # the newest kept, the oldest dropped
    assert sum(s.call == call.id for s in spans) == profiling.SPAN_LIMIT


def test_device_trace_writes_every_threads_spans(tmp_path):
    items, dec = _corpus(24), _decoder()
    with profiling.device_trace(str(tmp_path)):
        dec.decode_all(items)
    (path,) = [p for p in tmp_path.iterdir()
               if p.name.endswith(".pt.trace.json")]
    events = json.loads(path.read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "jpeg_tpu_torch"]
    (root,) = [e for e in ours if e["name"] == "decode.call"]
    caller = root["tid"]
    workers = [e for e in ours if e["tid"] != caller]
    assert {e["name"] for e in ours} == DECODE_SPANS
    assert {e["name"] for e in workers} >= {"decode.parse",
                                           "decode.host_entropy",
                                           "decode.k3_launch"}
    assert len({e["tid"] for e in workers}) >= 2
    for e in ours:
        assert e["args"]["call"] == root["args"]["span"]
        assert root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= (
            root["ts"] + root["dur"] + 1e-3)
    assert root["args"]["frames"] == len(items)
    # the caller's mirrored span is the profiler's own event, on its timeline
    (mirror,) = [e for e in events if e.get("name") == "decode.call"
                 and e.get("cat") == "user_annotation"]
    assert abs(mirror["ts"] - root["ts"]) < 1e3  # microseconds
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert all(e["tid"] in names for e in workers)


@pytest.mark.cuda
def test_span_holds_its_kernel_on_the_device_timeline():
    """A span around ``torch.cuda._sleep`` and a synchronise, mapped,
    contains the sleep kernel's interval on the card's timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    before = profiling.recorded_calls()
    acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.call("sleep.call"):
            with profiling.span("sleep"):
                torch.cuda._sleep(20_000_000)
                torch.cuda.synchronize()
    (call,) = _new_calls(before)
    sleep = next(s for s in profiling.recorded_spans([call.id])
                 if s.name == "sleep")
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not e.is_user_annotation()
               and e.duration_ns() > 1_000_000]
    (k,) = kernels
    assert call.to_unix_ns(sleep.start_ns) <= k.start_ns()
    assert k.start_ns() + k.duration_ns() <= call.to_unix_ns(sleep.end_ns)
