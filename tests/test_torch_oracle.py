"""The port's copies of the JAX package's NumPy reference decoders
(``engine="oracle"``), ``PipelineGeometry.component_gather_indices``,
``encode_cmyk`` and ``StageTimer``, each held to the JAX package's on the
same inputs: coefficients bit for bit (also against the port's C++ runtime,
on corrupt and truncated streams too), CMYK / YCCK streams byte for byte,
timer reports key for key.
"""

import io
import re
import time

import numpy as np
import pytest
from PIL import Image

from jpeg_tpu.entropy import arith as ref_arith
from jpeg_tpu.entropy import oracle as ref_oracle
from jpeg_tpu.entropy import progressive as ref_prog
from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu.io.corpus import synthetic_image
from jpeg_tpu.models import decoder as ref_dec
from jpeg_tpu.models import encoder as ref_enc
from jpeg_tpu.utils import profiling as ref_profiling
from jpeg_tpu_torch import decode_bytes, encode_cmyk
from jpeg_tpu_torch.entropy import arith, oracle, progressive
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.models import decoder as dec
from jpeg_tpu_torch.utils import profiling


def _pil(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _img(seed=4, size=(96, 128)):
    return synthetic_image(size[1], size[0], seed=seed)


# Streams of every entropy coding, at most 128x96 (the arithmetic decoders
# are Python loops over the QM coder).
STREAMS = {
    "baseline": lambda: _pil(_img(), quality=85),
    "baseline_rst2": lambda: ref_enc.encode_rgb(_img(5), quality=80,
                                                restart_interval_mcus=2),
    "baseline_gray": lambda: _pil(_img(6)[..., 0], quality=90),
    "progressive": lambda: _pil(_img(7), quality=85, progressive=True),
    "progressive_gray_q30": lambda: _pil(_img(8)[..., 0], quality=30,
                                         progressive=True),
    "progressive_ri3": lambda: ref_enc.encode_rgb_progressive(
        _img(9, (88, 104)), quality=85, restart_interval=3),
    "sof9": lambda: ref_enc.encode_rgb(_img(10), quality=85, arithmetic=True),
    "sof9_rst3": lambda: ref_enc.encode_rgb(_img(11), quality=85,
                                            arithmetic=True,
                                            restart_interval_mcus=3),
    "sof10": lambda: ref_enc.encode_rgb_progressive(_img(12), quality=85,
                                                    arithmetic=True),
}
DAMAGE = ["clean", "flip0", "flip1", "flip2", "trunc60", "trunc90"]


def _damaged(data: bytes, damage: str) -> bytes:
    """Three seeded byte flips in the second half of the file (the entropy
    payload), or the file cut to a share of its length."""
    if damage.startswith("trunc"):
        return data[: len(data) * int(damage[5:]) // 100]
    if damage.startswith("flip"):
        rng = np.random.default_rng(int(damage[4:]))
        d = bytearray(data)
        for _ in range(3):
            d[int(rng.integers(len(d) // 2, len(d) - 2))] ^= int(
                rng.integers(1, 128))
        return bytes(d)
    return data


def _outcome(fn, plan):
    """The array ``fn(plan)`` returns, or (exception type name, message)."""
    try:
        return np.array(fn(plan), copy=True)
    except ValueError as e:
        return (type(e).__name__, str(e))


def _ref_oracle(plan):
    if plan.arith_code:
        return (ref_arith.decode_progressive_coefficients_arith(plan)
                if plan.progressive else ref_arith.decode_coefficients_arith(plan))
    if plan.progressive:
        return ref_prog.decode_progressive_coefficients(plan)
    return ref_oracle.decode_coefficients(plan)


@pytest.mark.parametrize("damage", DAMAGE)
@pytest.mark.parametrize("kind", STREAMS)
def test_oracle_equals_jax_oracle_and_native(kind, damage):
    """The port's oracle route (``decode_coefficients_host(engine="oracle")``)
    gives the JAX package's oracle output bit for bit, or the same error;
    the port's C++ runtime gives the same coefficients wherever the oracle
    decodes, and raises (a ValueError) wherever it raises."""
    data = _damaged(STREAMS[kind](), damage)
    try:
        plan, ref_plan = parse_jpeg(data), ref_parse(data)
    except ValueError as e:  # a cut or flip that breaks the headers
        with pytest.raises(ValueError, match=re.escape(str(e))):
            ref_parse(data)
        return
    got = _outcome(lambda p: dec.decode_coefficients_host(p, "oracle"), plan)
    want = _outcome(_ref_oracle, ref_plan)
    native = _outcome(lambda p: dec.decode_coefficients_host(p, "native"), plan)
    if isinstance(want, tuple):
        assert got == want
        assert isinstance(native, tuple)
        return
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert isinstance(native, np.ndarray)
    np.testing.assert_array_equal(native, got)


@pytest.mark.parametrize("kind", ["baseline_rst2", "progressive", "sof9",
                                  "sof10"])
def test_oracle_modules_route_as_the_jax_decoder(kind):
    """Each copied decoder, called directly, equals its JAX original, and
    ``decode_bytes(engine="oracle")`` equals the native engine's pixels."""
    data = STREAMS[kind]()
    plan, ref_plan = parse_jpeg(data), ref_parse(data)
    pairs = {
        "baseline_rst2": (oracle.decode_coefficients,
                          ref_oracle.decode_coefficients),
        "progressive": (progressive.decode_progressive_coefficients,
                        ref_prog.decode_progressive_coefficients),
        "sof9": (arith.decode_coefficients_arith,
                 ref_arith.decode_coefficients_arith),
        "sof10": (arith.decode_progressive_coefficients_arith,
                  ref_arith.decode_progressive_coefficients_arith),
    }
    ours, theirs = pairs[kind]
    np.testing.assert_array_equal(ours(plan), theirs(ref_plan))
    np.testing.assert_array_equal(
        decode_bytes(data, engine="oracle", device="cpu"),
        decode_bytes(data, engine="native", device="cpu"))


def test_oracle_offsets_equal_jax():
    plan_data = STREAMS["baseline_rst2"]()
    got = oracle.decode_coefficients_with_offsets(parse_jpeg(plan_data))
    want = ref_oracle.decode_coefficients_with_offsets(ref_parse(plan_data))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_auto_engine_does_not_fall_back_to_the_oracle(monkeypatch):
    """A runtime that fails to load raises out of ``engine="auto"``; the JAX
    package would have decoded with the oracle."""
    from jpeg_tpu_torch import runtime

    def broken(*_a, **_k):
        raise OSError("simulated: the C++ runtime did not build")

    monkeypatch.setattr(dec, "native_decode_coefficients", broken)
    plan = parse_jpeg(STREAMS["baseline"]())
    with pytest.raises(OSError, match="simulated"):
        dec.decode_coefficients_host(plan, "auto")
    assert dec.decode_coefficients_host(plan, "oracle").shape == (
        plan.total_blocks, 64)
    assert runtime.native_decode_coefficients is not broken
    with pytest.raises(ValueError, match="engine"):
        dec.decode_coefficients_host(plan, "scalar")


@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (2, 2), (4, 1), None])
def test_component_gather_indices_equal(sampling):
    gray = sampling is None
    img = _img(3, (40, 72))
    data = ref_enc.encode_rgb(img[..., 0] if gray else img, grayscale=gray,
                              subsampling=sampling or (1, 1))
    geom = dec.PipelineGeometry.of(parse_jpeg(data))
    ref_geom = ref_dec.PipelineGeometry.of(ref_parse(data))
    got, want = geom.component_gather_indices(), ref_geom.component_gather_indices()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _cmyk(seed, size):
    rng = np.random.default_rng(seed)
    rgb = synthetic_image(size[1], size[0], seed=seed)
    k = rng.integers(0, 80, (*size, 1), dtype=np.uint8)
    return np.concatenate([255 - rgb, k], axis=-1)


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("ycck", [False, True])
@pytest.mark.parametrize("engine", ["native", "python"])
def test_encode_cmyk_byte_identical(engine, ycck, restart):
    """Adobe CMYK and YCCK streams, with and without restart markers, equal
    the JAX package's bytes on both entropy engines (and across them)."""
    for seed, size in ((1, (48, 72)), (2, (37, 53))):
        img = _cmyk(seed, size)
        kw = dict(quality=88, restart_interval_mcus=restart, ycck=ycck,
                  comment="port" if seed == 2 else None)
        got = encode_cmyk(img, engine=engine, **kw)
        assert got == ref_enc.encode_cmyk(img, engine=engine, **kw)
        assert got == encode_cmyk(img, engine="python" if engine == "native"
                                  else "native", **kw)
        plan = parse_jpeg(got)
        assert plan.color_model == ("ycck" if ycck else "cmyk")
        assert (plan.restart_interval or 0) == restart
        rgb = decode_bytes(got, device="cpu")
        assert rgb.shape == (*size, 3)


def test_encode_cmyk_refuses_what_the_port_lacks():
    """Arithmetic CMYK, once refused (ROADMAP item 3c), writes the JAX
    package's bytes; bad shapes and engines are still refused."""
    assert encode_cmyk(_cmyk(0, (16, 16)), arithmetic=True) == (
        ref_enc.encode_cmyk(_cmyk(0, (16, 16)), arithmetic=True))
    with pytest.raises(ValueError, match="CMYK"):
        encode_cmyk(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="engine"):
        encode_cmyk(_cmyk(0, (16, 16)), engine="gpu")


class _Clock:
    def __init__(self, step):
        self.t = 100.0
        self.step = step

    def __call__(self):
        self.t += self.step
        self.step *= 1.5
        return self.t


def _drive(timer):
    for i in range(3):
        with timer.stage("decode", frames=4, bytes=1_000_000 * (i + 1)):
            pass
    with timer.stage("encode", flops=2e9):
        pass
    with timer.stage("idle"):
        pass
    return timer


def test_stage_timer_reports_equal(monkeypatch):
    """The same stages on the same injected clock give the same report and
    dump in both packages."""
    monkeypatch.setattr(time, "perf_counter", _Clock(0.0125))
    got = _drive(profiling.StageTimer())
    monkeypatch.setattr(time, "perf_counter", _Clock(0.0125))
    want = _drive(ref_profiling.StageTimer())
    assert got.report() == want.report()
    assert set(got.report()["decode"]) == {
        "total_s", "calls", "mean_ms", "GB_per_s", "frames_per_s"}
    assert got.dump() == want.dump()


def test_device_trace_writes_a_trace(tmp_path):
    """``device_trace(None)`` is a no-op; with a directory, the block's
    operators land in a Chrome trace file there."""
    import torch

    with profiling.device_trace(None):
        pass
    with profiling.device_trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [p for p in tmp_path.iterdir() if p.name.endswith(".pt.trace.json")]
    assert len(files) == 1
    assert "aten::mm" in files[0].read_text()
