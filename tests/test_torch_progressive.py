"""Progressive and arithmetic entropy in jpeg_tpu_torch's host runtime,
against jpeg_tpu's, bit for bit; their route through K1's twin; K3 under the
JAX package's names; and the rule that the port builds its runtime from its
own copy of the C++ sources.

Streams: libjpeg progressive (PIL, every sampling, low quality on noise for
many refinement scans with successive approximation and EOBRUN), the JAX
package's progressive encoder with restart intervals, its SOF9 and SOF10
encoders, and the committed 4K fixtures the card decodes.
"""

import io
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from jpeg_tpu import runtime as ref_rt
from jpeg_tpu.entropy import device_window as ref_window
from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu.io.corpus import synthetic_image
from jpeg_tpu.models import decoder as ref_dec
from jpeg_tpu.models.encoder import encode_rgb, encode_rgb_progressive
from jpeg_tpu_torch import runtime
from jpeg_tpu_torch.entropy import device_huffman, device_window
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.models import decoder as dec
from jpeg_tpu_torch.utils import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "goldens", "torch")
PROG_4K = "synth_3840x2160_s5_q85_rst0_prog.jpg"
SOF9_4K = "synth_3840x2160_s6_q85_rst1_sof9.jpg"
K1_ROUTE_SMALL = ["synth_512x384_s7_q85_rst0_sof10.jpg",
                  "synth_512x384_s12_q85_rst0_gray_prog.jpg"]


def _pil(img, **kw) -> bytes:
    """Encode an array or a PIL image with PIL (libjpeg)."""
    buf = io.BytesIO()
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _noise(width, height, seed):
    rng = np.random.default_rng(seed)
    img = synthetic_image(width, height, seed=seed).astype(np.int16)
    return np.clip(img + rng.integers(-40, 40, img.shape), 0, 255).astype(np.uint8)


def _read(name) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


# name -> stream; every progressive case has successive approximation
# (libjpeg's default script refines each coefficient in a second scan).
def _prog_stream(case: str) -> bytes:
    img = synthetic_image(144, 112, seed=31)
    if case.startswith("pil_sub"):
        return _pil(img, quality=85, subsampling=int(case[-1]), progressive=True)
    if case == "pil_gray":
        return _pil(img[..., 0], quality=88, progressive=True)
    if case == "pil_noise_q30":  # many bits in the refinement scans, EOBRUN
        return _pil(_noise(200, 152, 7), quality=30, progressive=True)
    if case == "pil_noise_640x480":  # rows enough for the row-gated runner
        return _pil(_noise(640, 480, 8), quality=95, subsampling=2,
                    progressive=True)
    if case.startswith("jax_ri"):
        return encode_rgb_progressive(synthetic_image(104, 88, seed=96),
                                      quality=85,
                                      restart_interval=int(case[6:]))
    if case == "sof10":
        return encode_rgb_progressive(img, quality=85, arithmetic=True)
    if case == "sof10_ri3":
        return encode_rgb_progressive(img, quality=85, arithmetic=True,
                                      restart_interval=3)
    if case == "pil_cmyk":
        return _pil(Image.fromarray(img).convert("CMYK"), quality=85,
                    progressive=True)
    if case == "fixture_4k":
        return _read(PROG_4K)
    raise KeyError(case)


PROG_CASES = ["pil_sub0", "pil_sub1", "pil_sub2", "pil_gray", "pil_noise_q30",
              "pil_noise_640x480", "jax_ri1", "jax_ri5", "sof10", "sof10_ri3",
              "pil_cmyk", "fixture_4k"]


def _sof9_stream(case: str) -> bytes:
    if case == "fixture_4k":
        return _read(SOF9_4K)
    img = synthetic_image(150, 70, seed=12)
    rst = int(case[3:])
    return encode_rgb(img, quality=85, arithmetic=True,
                      restart_interval_mcus=rst)


SOF9_CASES = ["rst0", "rst1", "rst7", "fixture_4k"]


def _fresh_ref(fn, plan):
    """A JAX runtime plane decoder run into new buffers: a reused one keeps
    another geometry's samples in its pad (see
    test_reused_progressive_planes_zero_their_pad)."""
    saved, ref_rt._out_buffers = ref_rt._out_buffers, {}
    try:
        return fn(plan)
    finally:
        ref_rt._out_buffers = saved


def _equal_planes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.int16
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", PROG_CASES)
def test_progressive_coefficients_and_planes_bit_exact(case):
    data = _prog_stream(case)
    plan, ref = parse_jpeg(data), ref_parse(data)
    assert plan.progressive and len(plan.prog_scans) >= 6
    want = ref_rt.native_decode_progressive(ref)
    np.testing.assert_array_equal(runtime.native_decode_progressive(plan), want)
    # One thread runs the chains in order, with no row gate and no deferred
    # straggler scan: the same coefficients.
    np.testing.assert_array_equal(
        runtime.native_decode_progressive(plan, n_threads=1), want)
    _equal_planes(runtime.native_decode_progressive_planes(plan),
                  _fresh_ref(ref_rt.native_decode_progressive_planes, ref))
    np.testing.assert_array_equal(dec.decode_coefficients_host(plan), want)


@pytest.mark.parametrize("case", SOF9_CASES)
def test_sof9_coefficients_and_planes_bit_exact(case):
    data = _sof9_stream(case)
    plan, ref = parse_jpeg(data), ref_parse(data)
    assert plan.arith_code and not plan.progressive
    want = ref_rt.native_decode_arith_coefficients(ref)
    np.testing.assert_array_equal(
        runtime.native_decode_arith_coefficients(plan), want)
    np.testing.assert_array_equal(dec.decode_coefficients_host(plan), want)
    want_planes = _fresh_ref(ref_rt.native_decode_arith_planes, ref)
    _equal_planes(runtime.native_decode_arith_planes(plan, reuse_buffer=False),
                  want_planes)
    # A reused (bulk-zeroed) buffer gives the same planes, twice.
    for _ in range(2):
        _equal_planes(runtime.native_decode_arith_planes(plan), want_planes)
    with pytest.raises(ValueError, match="SOF9"):
        runtime.native_decode_arith_planes(parse_jpeg(_prog_stream("sof10")))


def test_progressive_planes_are_thread_scratch():
    """Two progressive frames of one geometry on one thread: the second
    decode overwrites the first's planes (the runtime's scratch contract),
    so a caller that keeps planes copies them, as the corpus worker does."""
    a = parse_jpeg(_pil(synthetic_image(96, 64, seed=1), quality=85,
                        progressive=True))
    b = parse_jpeg(_pil(synthetic_image(96, 64, seed=2), quality=85,
                        progressive=True))
    first = runtime.native_decode_progressive_planes(a)
    kept = [p.copy() for p in first]
    second = runtime.native_decode_progressive_planes(b)
    assert all(x is y for x, y in zip(first, second))
    assert not all(np.array_equal(k, s) for k, s in zip(kept, second))
    _equal_planes(kept, _fresh_ref(
        ref_rt.native_decode_progressive_planes,
        ref_parse(_pil(synthetic_image(96, 64, seed=1), quality=85,
                       progressive=True))))


def test_reused_progressive_planes_zero_their_pad():
    """Two geometries with one padded plane shape on one thread: the JAX
    runtime leaves the first frame's samples in the second's pad region;
    the port zeroes the pad, so its planes equal a fresh decode's."""
    big = _pil(synthetic_image(144, 112, seed=1), quality=85, progressive=True)
    small = _pil(synthetic_image(104, 88, seed=2), quality=85, progressive=True)
    runtime.native_decode_progressive_planes(parse_jpeg(big))
    got = runtime.native_decode_progressive_planes(parse_jpeg(small))
    want = _fresh_ref(ref_rt.native_decode_progressive_planes, ref_parse(small))
    _equal_planes(got, want)
    saved, ref_rt._out_buffers = ref_rt._out_buffers, {}
    try:
        ref_rt.native_decode_progressive_planes(ref_parse(big))
        stale = ref_rt.native_decode_progressive_planes(ref_parse(small))
    finally:
        ref_rt._out_buffers = saved
    assert int(np.abs(stale[0][:, 112:]).sum()) > 0  # the JAX runtime's pad
    assert int(np.abs(got[0][:, 112:]).sum()) == 0


def test_corrupt_progressive_scan_raises_native_error():
    data = bytearray(_prog_stream("pil_noise_q30"))
    plan = parse_jpeg(bytes(data))
    scan = plan.prog_scans[-1]
    start = bytes(data).find(bytes(scan.scan_data[:64]))
    data[start + 8 : start + 40] = b"\xff\x00" * 16  # an invalid prefix
    bad = parse_jpeg(bytes(data))
    with pytest.raises(runtime.NativeDecodeError):
        runtime.native_decode_progressive(bad)
    with pytest.raises(ref_rt.NativeDecodeError):
        ref_rt.native_decode_progressive(ref_parse(bytes(data)))


def test_ctypes_signatures_equal_jax():
    """Every entry point the port declares has the JAX package's restype
    and argtypes (one wrong entry corrupts memory without an error)."""

    class Fake:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.__dict__["fns"].setdefault(name, type(name, (), {})())

    port, ref = Fake(), Fake()
    runtime._configure(port)
    ref_rt._configure(ref)
    # jt_decode_lossless joined in its item 7, jt_decode_gap with item 9;
    # jt_decode_lossless_diffs is the port's own (jpegtpu_port.cpp).
    own = {"jt_decode_lossless_diffs"}
    assert len(port.fns) == 15 and own <= set(port.fns)
    assert not own & set(ref.fns)
    for name, fn in port.fns.items():
        if name in own:
            continue
        assert fn.restype == ref.fns[name].restype, name
        assert fn.argtypes == ref.fns[name].argtypes, name


@pytest.mark.parametrize("rounding", ["truncate", "round"])
@pytest.mark.parametrize("name", [PROG_4K, SOF9_4K, *K1_ROUTE_SMALL])
def test_k1_route_matches_jax_fast_path(name, rounding):
    """decode_bytes(path='fast') of progressive, SOF9 and SOF10 streams: the
    same planes into K1's twin, within +-1 u8 of JAX's fast path (Pallas
    interpret), the bar tests/test_torch_fused_plane.py holds baseline to."""
    data = _read(name)
    got = dec.decode_bytes(data, rounding=rounding, path="fast", device="cpu")
    want = np.asarray(ref_dec.decode_bytes(data, rounding=rounding, path="fast"))
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05
    np.testing.assert_array_equal(
        got, dec.decode_plan_fast(parse_jpeg(data), rounding, "cpu"))


def test_oracle_engine_raises_on_every_entropy_coding():
    """``engine='oracle'``, once refused on every entropy coding, now
    decodes each (progressive, SOF10, SOF9, baseline) to the native
    engine's coefficients."""
    for data in (_prog_stream("pil_sub2"), _prog_stream("sof10"),
                 _sof9_stream("rst1"), encode_rgb(synthetic_image(32, 32, 1))):
        plan = parse_jpeg(data)
        np.testing.assert_array_equal(
            dec.decode_coefficients_host(plan, "oracle"),
            dec.decode_coefficients_host(plan, "native"))


def _restart_corpus(n):
    return [encode_rgb(synthetic_image(96, 64, seed=i), quality=85,
                       restart_interval_mcus=3) for i in range(n)]


def test_device5_names_equal_jax():
    """K3 (its plain twin here) under decode_coefficients_device5[_batch]
    against the JAX functions (Pallas interpret) on the same streams."""
    streams = _restart_corpus(3)
    plans = [parse_jpeg(d) for d in streams]
    refs = [ref_parse(d) for d in streams]
    got, err = device_window.decode_coefficients_device5_batch(plans,
                                                                device="cpu")
    want, werr = ref_window.decode_coefficients_device5_batch(refs,
                                                              interpret=True)
    assert isinstance(err, np.ndarray) and err.shape == (len(werr),)
    np.testing.assert_array_equal(err, np.asarray(werr))
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))
    one, one_err = device_window.decode_coefficients_device5(plans[0],
                                                             device="cpu")
    ref_one, ref_one_err = ref_window.decode_coefficients_device5(
        refs[0], interpret=True)
    np.testing.assert_array_equal(one, ref_one)
    np.testing.assert_array_equal(one_err, ref_one_err)
    # to_host=False: tensors on the device, the same values.
    t, terr = device_window.decode_coefficients_device5_batch(
        plans, device="cpu", to_host=False)
    assert all(isinstance(x, torch.Tensor) for x in t)
    assert torch.equal(terr, torch.from_numpy(err))
    for x, g in zip(t, got):
        np.testing.assert_array_equal(x.numpy(), g)


def test_device5_mismatch_raises_before_launch(monkeypatch):
    def no_launch(*args, **kwargs):
        raise AssertionError("launched")

    monkeypatch.setattr(device_huffman, "decode_lanes", no_launch)
    plans = [parse_jpeg(_restart_corpus(1)[0]),
             parse_jpeg(encode_rgb(synthetic_image(96, 64, seed=9), quality=85,
                                   restart_interval_mcus=3, optimize=True))]
    with pytest.raises(ValueError, match="identical slot structure"):
        device_window.decode_coefficients_device5_batch(plans, device="cpu")
    with pytest.raises(device_huffman.BatchMismatch):
        device_window.decode_coefficients_device5_batch(plans[::-1],
                                                        device="cpu")


def test_port_builds_nothing_inside_the_jax_package(monkeypatch):
    """Every source and header the port compiles lies in jpeg_tpu_torch/:
    the host runtime and encoder are built from the port's own copies, and
    each CUDA kernel from csrc/."""
    from jpeg_tpu_torch.entropy import device_kernel
    from jpeg_tpu_torch.ops import fused_encode, fused_plane, idct_only

    pkg = os.path.realpath(os.path.join(REPO, "jpeg_tpu_torch")) + os.sep
    seen = []
    real = build.build_library

    class Stop(Exception):
        pass

    def spy(name, compiler, sources, headers=()):
        seen.extend([*sources, *headers])
        if compiler[0] == "g++":
            return real(name, compiler, sources, headers)
        raise Stop(name)  # no nvcc here: record, do not compile

    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build_library", spy)
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    runtime.load()
    runtime.load_encoder()
    for mod in (fused_plane, fused_encode, device_huffman, device_kernel,
                idct_only):
        with pytest.raises(Stop):
            mod.load_kernel()
    assert len(seen) >= 2 + 5
    for path in seen:
        assert os.path.realpath(path).startswith(pkg), path
        assert os.path.exists(path), path
    for src in (runtime.SOURCE, runtime.ENC_SOURCE):
        with open(src, "rb") as f, open(src.replace(
                os.path.join("jpeg_tpu_torch", "runtime"),
                os.path.join("jpeg_tpu", "runtime")), "rb") as g:
            assert f.read() == g.read(), "the copy differs from its source"


def test_port_code_joins_no_jax_package_path():
    """No port code names the JAX package's directory as a path component
    (docstrings naming a counterpart file stay allowed)."""
    pat = re.compile(r"""(['"])jpeg_tpu\1""")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "jpeg_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_scratch_planes_are_per_thread():
    """Scratch buffers live in thread-local storage: a worker thread's
    planes are its own (the JAX package keys a global dict by thread id)."""
    import threading

    plan = parse_jpeg(_prog_stream("pil_sub2"))
    main = runtime.native_decode_progressive_planes(plan)
    box = {}
    t = threading.Thread(target=lambda: box.update(
        p=runtime.native_decode_progressive_planes(plan)))
    t.start()
    t.join()
    assert all(a is not b for a, b in zip(main, box["p"]))
    _equal_planes(main, box["p"])
