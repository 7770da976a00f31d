"""The corpus decoder's pixel stage streamed behind its entropy phase.

On the CPU: the staging buffer's filled-slot tracker
(``Staging.fill`` / ``wait_runs``), the rule that decides where the
decoder streams, and the streamed schedule itself, run through K1's plain
twin by forcing that rule on (``_streams``), held bit-equal to the
unstreamed order. Marked ``cuda``: the same on the card, where the
decoder streams by itself.

This file imports neither jax nor jpeg_tpu, so its card tests also run on
a machine without them (tests/conftest.py imports jax; skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_pixel_stream.py
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from jpeg_tpu_torch import BatchedCorpusDecoder, encode_rgb
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.io.corpus import synthetic_image
from jpeg_tpu_torch.models.decoder import PipelineGeometry
from jpeg_tpu_torch.parallel import pipeline
from jpeg_tpu_torch.parallel.mesh import make_mesh
from jpeg_tpu_torch.parallel.staging import Staging

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens", "torch")
UHD = ["synth_3840x2160_s0_q85_rst1.jpg", "synth_3840x2160_s1_q85_rst1.jpg"]
CALL_SIZES = [1, 7, 8, 9, 64, 65]


def _frames(n, width=96, height=64, **enc):
    enc = dict(dict(quality=85, subsampling=(2, 2), restart_interval_mcus=3),
               **enc)
    return [encode_rgb(synthetic_image(width, height, seed=i), **enc)
            for i in range(n)]


def _gray(n):
    return [encode_rgb(synthetic_image(96, 64, seed=i)[..., 1].copy(),
                       quality=85, restart_interval_mcus=3, grayscale=True)
            for i in range(n)]


def _poisoned(data: bytes) -> bytes:
    """Eight stuffed 0xFF bytes in the middle of restart segment 1: an
    invalid prefix for any decoder, so the frame fails its K3 lane."""
    b = bytearray(data)
    rst = [i for i in range(len(b) - 1)
           if b[i] == 0xFF and 0xD0 <= b[i + 1] <= 0xD7]
    mid = (rst[0] + rst[1]) // 2
    while b[mid - 1] == 0xFF:
        mid += 1
    b[mid : mid + 16] = b"\xff\x00" * 8
    return bytes(b)


def _geom(data):
    return PipelineGeometry.of(parse_jpeg(data))


def _staging(capacity):
    """A CPU staging with a buffer of ``capacity`` slots for the test
    frames' geometry, as a first call of that many frames leaves it; the
    next call begun."""
    st, geom = Staging(torch.device("cpu")), _geom(_frames(1)[0])
    st.begin()
    for _ in range(capacity):
        st.take(geom)
    st.bucket(geom, {})
    st.begin()
    return st, geom


class _Waiter:
    """``wait_runs`` on its own thread, as the caller waits during the
    entropy phase; ``stop()`` makes ``done`` true and wakes it."""

    def __init__(self, st, least):
        self.st, self.stopped, self.got = st, threading.Event(), None
        self.t = threading.Thread(target=self._run, args=(least,))
        self.t.start()

    def _run(self, least):
        self.got = self.st.wait_runs(least, self.stopped.is_set)

    def result(self, timeout=30):
        self.t.join(timeout)
        assert not self.t.is_alive()
        return self.got

    def stop(self):
        self.stopped.set()
        self.st.wake()
        return self.result()


def test_runs_come_in_slot_order():
    """Slots filled out of order come back as runs in slot order, each
    run every consecutive filled slot after the last run, whole."""
    st, geom = _staging(8)
    for _ in range(8):
        assert st.take(geom)[1] is not None
    for slot in (1, 0):
        st.fill(geom, slot, f"f{slot}")
    assert st.wait_runs(2, lambda: False) == [(geom, ["f0", "f1"])]
    for slot in (5, 3, 2, 4, 7):
        st.fill(geom, slot, f"f{slot}")
    # 2..5 are consecutive after the last run; 7 waits behind 6
    assert st.wait_runs(2, lambda: False) == [
        (geom, ["f2", "f3", "f4", "f5"])]
    st.fill(geom, 6, "f6")
    assert st.wait_runs(2, lambda: False) == [(geom, ["f6", "f7"])]
    # done() ends the wait at once, with or without a run ready
    assert st.wait_runs(1, lambda: True) is None


def test_unfilled_slot_blocks_the_run_behind_it():
    """A slot taken but not yet filled holds back every filled slot after
    it; filling it hands the whole run out. A new call forgets the last
    one's runs."""
    st, geom = _staging(6)
    for _ in range(5):
        st.take(geom)
    for slot in (1, 2, 3, 4):
        st.fill(geom, slot, slot)
    w = _Waiter(st, 2)
    w.t.join(0.3)
    assert w.t.is_alive()  # slot 0 taken, unfilled: no run
    st.fill(geom, 0, 0)
    assert w.result() == [(geom, [0, 1, 2, 3, 4])]
    w = _Waiter(st, 2)
    w.t.join(0.2)
    assert w.t.is_alive()
    assert w.stop() is None
    st.begin()
    st.take(geom)
    st.take(geom)
    st.fill(geom, 1, "b")
    st.fill(geom, 0, "a")
    assert st.wait_runs(2, lambda: False) == [(geom, ["a", "b"])]


def test_runs_of_two_geometries_come_together():
    """Each geometry's runs are its own; one wait hands out every
    geometry's run that is long enough."""
    st = Staging(torch.device("cpu"))
    ga, gb = _geom(_frames(1)[0]), _geom(_gray(1)[0])
    assert ga != gb
    st.begin()
    for g in (ga, gb):
        for _ in range(4):
            st.take(g)
        st.bucket(g, {})
    st.begin()
    for g in (ga, gb):
        for _ in range(4):
            st.take(g)
    st.fill(ga, 0, "a0")
    st.fill(gb, 0, "b0")
    st.fill(gb, 1, "b1")
    assert st.wait_runs(2, lambda: False) == [(gb, ["b0", "b1"])]
    st.fill(ga, 1, "a1")
    st.fill(gb, 2, "b2")
    assert st.wait_runs(1, lambda: False) == [(ga, ["a0", "a1"]),
                                              (gb, ["b2"])]


def test_host_and_device_fills_interleave():
    """A host-like and a device-like thread take and fill slots at once,
    with a tiny switch interval, while the caller waits for runs: every
    filled slot is handed out once, in slot order, the runs one after the
    other from slot 0, none shorter than asked."""
    n, least = 64, 4
    st, geom = _staging(n)
    out: dict = {}
    finished = []

    def filler(who, count):
        for j in range(count):
            slot, views = st.take(geom)
            assert views is not None
            views[0][...] = slot  # the copy into the slot
            out[slot] = (who, j)
            st.fill(geom, slot, (who, j))
            time.sleep(0)  # let the other filler and the waiter in
        finished.append(who)  # what done() reads, then the wake it needs
        st.wake()

    threads = [threading.Thread(target=filler, args=("host", 40)),
               threading.Thread(target=filler, args=("device", 24))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    runs = []
    try:
        for t in threads:
            t.start()
        done = lambda: len(finished) == len(threads)  # noqa: E731
        while (got := st.wait_runs(least, done)) is not None:
            runs.extend(got)
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    handed = [f for g, frames in runs for f in frames]
    assert all(g == geom and len(frames) >= least for g, frames in runs)
    assert handed == [out[s] for s in range(len(handed))]
    assert len(handed) <= n
    buf = st.buffers[geom]
    for s in range(n):  # every slot holds what its taker copied there
        assert (buf.planes[0][s] == np.int16(s)).all()


def test_capacity_edge():
    """Slots past the buffer's capacity have no views, are never filled
    and never run: the runs stop at the capacity."""
    st, geom = _staging(3)
    for slot in range(5):
        got, views = st.take(geom)
        assert got == slot and (views is None) == (slot >= 3)
        if views is not None:
            st.fill(geom, slot, slot)
    assert st.wait_runs(1, lambda: False) == [(geom, [0, 1, 2])]
    w = _Waiter(st, 1)
    w.t.join(0.2)
    assert w.t.is_alive()  # nothing past slot 2 is ever filled
    assert w.stop() is None


def test_cpu_decoder_streams_nothing():
    """The CPU, a mesh and the card: only a CUDA decoder without a mesh
    streams, and a CPU decoder's warm calls stream no frame."""
    assert BatchedCorpusDecoder(device="cuda")._streams()
    mesh = make_mesh(n_data=2, devices=["cpu"] * 2)
    assert not BatchedCorpusDecoder(device="cpu", mesh=mesh)._streams()
    items = _frames(24)
    for hybrid in (False, True):
        dec = BatchedCorpusDecoder(workers=2, hybrid_device=hybrid,
                                   device_batch=2, device="cpu")
        assert not dec._streams()
        for _ in range(3):
            dec.decode_all(items)
        assert dec.streamed_frames == 0 and dec.pixel_launches == 3
        dec.close()


def _gate(monkeypatch, dec, hold):
    """Hold the parse of ``hold`` (bytes, by identity) until ``dec`` has
    launched a streamed run, so a run launches during the entropy phase
    whatever the threads' timing. Returns the event the first streamed
    run sets."""
    launched = threading.Event()
    stage, parse = dec._pixel_stage, pipeline.parse_jpeg

    def spied(*args):
        stage(*args)
        if args[5] is None:  # no ``unslotted``: a streamed run
            launched.set()

    def held(data):
        if data is hold:
            assert launched.wait(timeout=60), "no run streamed"
        return parse(data)

    monkeypatch.setattr(dec, "_pixel_stage", spied)
    monkeypatch.setattr(pipeline, "parse_jpeg", held)
    return launched


def _decoders(device, hybrid, force, **kw):
    """A decoder that streams and one held to the unstreamed order."""
    kw = dict(dict(workers=2, hybrid_device=hybrid, device=device), **kw)
    dec, ref = BatchedCorpusDecoder(**kw), BatchedCorpusDecoder(**kw)
    if force:
        dec._streams = lambda: True
    ref._streams = lambda: False
    return dec, ref


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.ok == w.ok and g.error == w.error
        if w.ok:
            assert g.rgb.dtype == w.rgb.dtype
            np.testing.assert_array_equal(g.rgb, w.rgb)


def _check_sizes(monkeypatch, device, force, frames, hybrid):
    """A warm-up call of 64 frames (the buffer's first: nothing streams),
    then calls of 1, 7, 8, 9, 64 and 65 frames (65 grows the buffer and
    its result array), each bit-equal to the unstreamed order; every call
    of more than ``device_batch`` frames streams a run (gated)."""
    dec, ref = _decoders(device, hybrid, force)
    k = dec.device_batch
    assert dec.decode_all(frames[:64]) and dec.streamed_frames == 0
    for n in CALL_SIZES:
        items = list(frames[:n])
        streamed = dec.streamed_frames
        if n > k:
            launched = _gate(monkeypatch, dec, items[-1])
        got = dec.decode_all(items)
        monkeypatch.undo()
        _same(got, ref.decode_all(items))
        s = dec.streamed_frames - streamed
        assert s <= min(n, 64)
        if n > k:
            assert launched.is_set() and s >= k
        if n < k:
            assert s == 0
    (buf,) = dec._staging.buffers.values()
    assert buf.capacity == 65
    dec.close()
    ref.close()


@pytest.mark.parametrize("hybrid", [False, True])
def test_streamed_order_equals_unstreamed(monkeypatch, hybrid):
    _check_sizes(monkeypatch, "cpu", True, _frames(65), hybrid)


def _mixed(n_fast=24):
    """Two K1 geometries, a compat (CMYK) frame, a frame that is no JPEG,
    and a frame that fails its K3 lane (sent back to the host)."""
    color = _frames(n_fast)
    gray = _gray(6)
    with open(os.path.join(FIXTURES, "synth_512x384_s8_q85_rst0_cmyk.jpg"),
              "rb") as f:
        cmyk = f.read()
    items = color[:10] + gray[:3] + [cmyk, b"not a jpeg"] + color[10:]
    return items[:-2] + [_poisoned(items[-2])] + gray[3:] + items[-1:]


def _check_mixed(monkeypatch, device, force):
    items = _mixed()
    dec, ref = _decoders(device, True, force, device_batch=4)
    want = ref.decode_all(items)
    assert not want[14].ok and "JPEGError" in want[14].error
    assert want[13].ok  # the CMYK frame, decoded inline
    for call in range(3):
        streamed = dec.streamed_frames
        if call:
            _gate(monkeypatch, dec, items[9])
        _same(dec.decode_all(items), want)
        monkeypatch.undo()
        assert (dec.streamed_frames > streamed) == bool(call)
    assert {"host", "device", "fallback"} <= set(dec.routes)
    assert len(dec._staging.buffers) == 2
    dec.close()
    ref.close()


def test_stream_mixed_call(monkeypatch):
    """Two geometries, compat, error and fallback frames in one hybrid
    call, streamed from the second call on: equal to the unstreamed
    order."""
    _check_mixed(monkeypatch, "cpu", True)


def _check_held(device, force):
    """A caller that keeps every call's results: each call's arrays stay
    unchanged, byte for byte, after later streamed calls."""
    items = _frames(40)
    dec, ref = _decoders(device, True, force, device_batch=4)
    want = ref.decode_all(items)
    kept, copies = [], []
    for _ in range(4):
        got = dec.decode_all(items)
        _same(got, want)
        kept.append(got)
        copies.append([r.rgb.copy() for r in got])
    for got, c in zip(kept, copies):
        for r, w in zip(got, c):
            np.testing.assert_array_equal(r.rgb, w)
    assert len(dec._staging.rgb[_geom(items[0])]) <= 2
    dec.close()
    ref.close()


def test_stream_results_held_across_calls():
    _check_held("cpu", True)


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hybrid", [False, True])
def test_card_streamed_order_equals_unstreamed(cuda, monkeypatch, hybrid):
    """As on the CPU, on the card without forcing: calls of 1, 7, 8, 9,
    64 and 65 frames bit-equal to the unstreamed order."""
    _check_sizes(monkeypatch, cuda, False, _frames(65, 256, 128), hybrid)


@pytest.mark.cuda
def test_card_stream_mixed_call(cuda, monkeypatch):
    _check_mixed(monkeypatch, cuda, False)


@pytest.mark.cuda
def test_card_stream_results_held_across_calls(cuda):
    _check_held(cuda, False)


@pytest.mark.cuda
def test_card_streams_warm_4k_calls(cuda, monkeypatch):
    """64 warm 4K frames a call, the benchmark's call, with no gate: runs
    launch during the entropy phase (``streamed_frames`` on the decoder
    and on ``decode.call``), each waited for by a blocking-sync event, and
    the results equal the unstreamed order."""
    from jpeg_tpu_torch.utils import profiling

    frames = []
    for name in UHD:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            frames.append(f.read())
    items = frames * 32
    dec, ref = _decoders(cuda, True, False, workers=os.cpu_count() or 1)
    want = ref.decode_all(items)
    dec.decode_all(items)  # the buffers' first call: nothing streams
    assert dec.streamed_frames == 0
    events, event = [], torch.cuda.Event

    def spy(*args, **kwargs):
        events.append(kwargs.get("blocking", False))
        return event(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "Event", spy)
    launches = dec.pixel_launches
    before = profiling.recorded_calls()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]  # as the benchmark traces
    with torch.profiler.profile(activities=acts):
        got = dec.decode_all(items)
    _same(got, want)
    seen = {c.id for c in before}
    (call,) = [c for c in profiling.recorded_calls() if c.id not in seen]
    spans = profiling.recorded_spans([call.id])
    (root,) = [s for s in spans if s.parent == 0]
    assert root.counts["streamed_frames"] == dec.streamed_frames > 0
    assert root.counts["k1_launches"] == dec.pixel_launches - launches > 1
    assert events and all(events)
    assert len(events) == dec.pixel_launches - launches
    (entropy,) = [s for s in spans if s.name == "decode.entropy"]
    inside = [s for s in spans if s.name == "decode.pixel"
              and s.parent == entropy.id]
    assert sum(s.counts["frames"] for s in inside) == dec.streamed_frames
    dec.close()
    ref.close()
