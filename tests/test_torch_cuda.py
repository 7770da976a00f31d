"""jpeg_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``; each test skips where no CUDA device is present.

This file imports neither jax nor jpeg_tpu, so it also runs on a machine
without them (tests/conftest.py imports jax; skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from jpeg_tpu_torch import (
    BatchedCorpusDecoder,
    decode_bytes,
    encode_rgb,
    encode_rgb_device,
)
from jpeg_tpu_torch.entropy import device_decode as v1
from jpeg_tpu_torch.entropy import device_huffman as k3
from jpeg_tpu_torch.entropy import device_kernel as k4
from jpeg_tpu_torch.entropy import device_spec as k7
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.models import encoder
from jpeg_tpu_torch.models.decoder import (
    PipelineGeometry,
    coefficient_planes_from_blocks,
)
from jpeg_tpu_torch.ops import fused_encode as k2
from jpeg_tpu_torch.ops import fused_plane as k1
from jpeg_tpu_torch.ops import idct_only as k56
from jpeg_tpu_torch.runtime import (
    native_decode_coefficients,
    native_decode_planes,
)

pytestmark = pytest.mark.cuda

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens", "torch")
SMALL = ["synth_512x384_s2_q85_rst1.jpg", "synth_512x384_s3_q85_rst0.jpg",
         "synth_512x384_s4_q85_rst1_gray.jpg"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("rounding", ["truncate", "round"])
@pytest.mark.parametrize("name", SMALL)
def test_k1_kernel_equals_plain(cuda, name, rounding):
    """Same fp32 operations in the same order: identical pixels."""
    plan = parse_jpeg(_read(name))
    geom = PipelineGeometry.of(plan)
    planes = [torch.from_numpy(p.copy()).unsqueeze(0).to(cuda)
              for p in native_decode_planes(plan)]
    qt = torch.from_numpy(k1.plan_quant_patterns(plan, geom)).unsqueeze(0).to(cuda)
    before = k1.LAUNCHES.value
    got = k1.fused_plane_decode(planes, qt, geom, rounding)
    assert k1.LAUNCHES.value == before + 1
    want = k1.fused_plane_decode_plain(planes, qt, geom, rounding)
    assert torch.equal(got, want)


# Every sampling K1 takes: luma (h, v) factors over 1x1 chroma, and gray.
K1_SAMPLINGS = {"1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2),
                "4x1": (4, 1), "4x4": (4, 4), "gray": None}


@pytest.mark.parametrize("rounding", ["truncate", "round"])
@pytest.mark.parametrize("sampling", K1_SAMPLINGS)
def test_k1_kernel_equals_plain_every_sampling(cuda, sampling, rounding):
    """Seeded images encoded by the port at each sampling (two per batch,
    an odd size so the padded tiles and bands are partly empty)."""
    sub = K1_SAMPLINGS[sampling]
    plans = []
    for seed in (1, 2):
        img = _image(520, 200, seed)
        data = (encode_rgb(img[..., 0], quality=90, grayscale=True) if sub is None
                else encode_rgb(img, quality=90, subsampling=sub))
        plans.append(parse_jpeg(data))
    geom = PipelineGeometry.of(plans[0])
    host = [native_decode_planes(p) for p in plans]
    planes = [torch.from_numpy(np.stack([h[c] for h in host])).to(cuda)
              for c in range(len(host[0]))]
    qt = torch.from_numpy(np.stack(
        [k1.plan_quant_patterns(p, geom) for p in plans])).to(cuda)
    before = k1.LAUNCHES.value
    got = k1.fused_plane_decode(planes, qt, geom, rounding)
    assert k1.LAUNCHES.value == before + 1
    assert torch.equal(got, k1.fused_plane_decode_plain(planes, qt, geom, rounding))


def test_k1_fast_division_matches_ieee(cuda):
    """K1 divides by 0.587 with one reciprocal product and one correction
    where |x| is 0 or in [2^-100, 2^100]: there it gives IEEE division's
    bits for every float. Among denormals it does not, hence the guard."""
    assert k1.division_mismatches(device=cuda)[0] == 0
    assert k1.division_mismatches(2.0**-149, 2.0**-127, device=cuda)[0] > 0


def test_k3_kernel_equals_plain_and_cpp_on_4k_frame(cuda):
    """One 3840x2160 fixture frame (135 lanes): every row and the err vector
    equal the plain twin's; as planes, the C++ decoder's."""
    plan = parse_jpeg(_read("synth_3840x2160_s0_q85_rst1.jpg"))
    batch = k3.prepare_lane_batch([plan])
    lanes = k3.lane_tensors(batch, cuda)
    n = len(batch.lane_start)
    ck, ek = k3.decode_lanes(lanes, n, batch.total_rows)
    cp, ep = k3.decode_lanes_plain(lanes, n, batch.total_rows)
    assert not ek.any() and torch.equal(ek, ep)
    assert torch.equal(ck, cp)
    planes = coefficient_planes_from_blocks(ck, PipelineGeometry.of(plan))
    for got, want in zip(planes, native_decode_planes(plan)):
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("name", [SMALL[0], SMALL[2]])
def test_k3_kernel_equals_plain_on_corrupt_streams(cuda, name):
    base = parse_jpeg(_read(name))
    rng = np.random.default_rng(3)
    plans = [base]
    for _ in range(6):
        p = parse_jpeg(_read(name))
        pos = rng.choice(len(p.scan_data), size=2, replace=False)
        p.scan_data[pos] ^= rng.integers(1, 256, size=2).astype(np.uint8)
        plans.append(p)
    batch = k3.prepare_lane_batch(plans)
    lanes = k3.lane_tensors(batch, cuda)
    n = len(batch.lane_start)
    before = k3.LAUNCHES.value
    ck, ek = k3.decode_lanes(lanes, n, batch.total_rows)
    assert k3.LAUNCHES.value == before + 1
    cp, ep = k3.decode_lanes_plain(lanes, n, batch.total_rows)
    assert torch.equal(ek, ep)
    assert torch.equal(ck, cp)


@pytest.mark.parametrize("runner", ["single", "batch"])
@pytest.mark.parametrize("name", [SMALL[0], SMALL[2]])
def test_k4_kernel_equals_plain_on_corrupt_streams(cuda, name, runner):
    """Raw K4 outputs, every element and every flag, equal the plain
    version's; the decoded coefficients of the clean image equal K3's."""
    base = parse_jpeg(_read(name))
    rng = np.random.default_rng(5)
    plans = [base]
    for _ in range(6):
        p = parse_jpeg(_read(name))
        pos = rng.choice(len(p.scan_data), size=2, replace=False)
        p.scan_data[pos] ^= rng.integers(1, 256, size=2).astype(np.uint8)
        plans.append(p)
    if runner == "single":
        run, args, mm, _ = k4.kernel_runner(plans[1], device=cuda)
    else:
        run, args, mm, _, _ = k4.kernel_runner_batch(plans, device=cuda)
    before = k4.LAUNCHES.value
    out, err = run(*args)
    assert k4.LAUNCHES.value == before + 1
    plain_out, plain_err = k4.decode_words_plain(
        *args, *k4.kernel_constants(base, cuda), mm)
    assert torch.equal(err, plain_err)
    assert torch.equal(out, plain_out)
    got, gerr = k4.decode_coefficients_device4(base, device=cuda)
    want, werr = v1.decode_coefficients_device_batch([base], device=cuda)
    assert not gerr.any() and not werr.any()
    np.testing.assert_array_equal(got, want[0].cpu().numpy())


def _mixed_interval_plans(copies):
    """Images of three sizes and restart intervals (4:2:0, shared tables):
    their lanes differ in ``nblk``; 13 lanes a copy."""
    rng = np.random.default_rng(60)
    plans = []
    for _ in range(copies):
        for shape, ri in [((48, 64), 4), ((80, 96), 8), ((64, 48), 2)]:
            img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
            plans.append(parse_jpeg(encode_rgb(
                img, quality=85, subsampling=(2, 2), restart_interval_mcus=ri)))
    return plans


@pytest.mark.parametrize("copies", [1, 3])
def test_k4_kernel_equals_plain_on_uneven_lanes(cuda, copies):
    """Lanes with different block counts (zeros past a lane's blocks) and
    a lane count that is no multiple of 32 (13 and 39), one of them corrupt:
    every element and flag equals the plain version's."""
    plans = _mixed_interval_plans(copies)
    s = plans[1].segments[1]
    mid = (s.byte_start + s.byte_end) // 2
    plans[1].scan_data[mid : mid + 8] = 0xFF  # an invalid prefix mid-lane
    run, args, mm, n, _ = k4.kernel_runner_batch(plans, device=cuda)
    assert n == 13 * copies and len(set(args[3][0].tolist())) > 1
    before = k4.LAUNCHES.value
    out, err = run(*args)
    assert k4.LAUNCHES.value == before + 1
    plain_out, plain_err = k4.decode_words_plain(
        *args, *k4.kernel_constants(plans[0], cuda), mm)
    assert bool(err.any()) and torch.equal(err, plain_err)
    assert torch.equal(out, plain_out)
    # The same through decode_words without prebuilt tables.
    again, again_err = k4.decode_words(
        *args, *k4.kernel_constants(plans[0], cuda), mm)
    assert torch.equal(again, out) and torch.equal(again_err, err)


def test_k3_equals_k4_and_plain_on_uneven_lanes(cuda):
    """K3 and K4 read their pass bodies from one header: on clean streams
    both give the same coefficients per image, and K3 its plain twin's."""
    plans = _mixed_interval_plans(2)
    batch = k3.prepare_lane_batch(plans)
    lanes = k3.lane_tensors(batch, cuda)
    n = len(batch.lane_start)
    ck, ek = k3.decode_lanes(lanes, n, batch.total_rows)
    cp, ep = k3.decode_lanes_plain(lanes, n, batch.total_rows)
    assert not ek.any() and torch.equal(ek, ep) and torch.equal(ck, cp)
    got, err = k4.decode_coefficients_device4_batch(plans, device=cuda,
                                                    to_host=False)
    assert not err.any()
    for g, (r0, rows) in zip(got, batch.images):
        assert torch.equal(g, ck[r0 : r0 + rows])


@pytest.mark.parametrize("shape", [(128, 256), (512, 768)])
@pytest.mark.parametrize("kernel", ["K5", "K6"])
def test_k5_k6_kernels_equal_plain(cuda, kernel, shape):
    """Same fp32 operations in the same order: equal values (K5 == K6 too)."""
    rng = np.random.default_rng(shape[0])
    x = torch.from_numpy(rng.integers(-512, 512, shape).astype(np.int16)).to(cuda)
    qpat = torch.from_numpy(k56.quant_pattern(np.arange(1, 65), 128, 256)).to(cuda)
    build, counter, plain = {
        "K5": (k56.idct_only_kernel, k56.LAUNCHES, k56.idct_only_plain),
        "K6": (k56.idct_only_kernel_roll, k56.LAUNCHES_ROLL,
               k56.idct_only_roll_plain)}[kernel]
    before = counter.value
    got = build(*shape)(x, qpat)
    assert counter.value == before + 1
    assert torch.equal(got, plain(x, qpat))
    assert torch.equal(got, k56.idct_only_plain(x, qpat))


def test_hybrid_corpus_on_card(cuda):
    items = [_read(SMALL[1]), _read(SMALL[2])] + [_read(SMALL[0])] * 12
    dec = BatchedCorpusDecoder(workers=2, hybrid_device=True, device_batch=2,
                               device=cuda)
    got = dec.decode_all(items)
    dec.close()
    assert dec.device_frames > 0
    for data, r in zip(items, got):
        assert r.ok
        np.testing.assert_array_equal(
            r.rgb, decode_bytes(data, path="fast", device="cpu"))


def test_corpus_staging_is_page_locked_on_card(cuda):
    """K1's input goes up from page-locked staging: every K1 frame of a
    call counts in ``pinned_frames``, the buffer is pinned memory to
    PyTorch, a second call of the same size writes every frame straight
    into its slot, and a refused registration leaves no error behind for
    the next launch."""
    from jpeg_tpu_torch.parallel import staging

    items = [_read(SMALL[0])] * 12 + [_read(SMALL[2])] * 3  # two geometries
    dec = BatchedCorpusDecoder(workers=2, hybrid_device=True, device_batch=2,
                               device=cuda)
    for call in range(2):
        pinned, staged = dec.pinned_frames, dec.staged_frames
        got = dec.decode_all(items)
        assert dec.pinned_frames - pinned == len(items)
        assert dec.staged_frames - staged == (len(items) if call else 0)
        for data, r in zip(items, got):
            np.testing.assert_array_equal(
                r.rgb, decode_bytes(data, path="fast", device="cpu"))
    assert dec.device_frames > 0
    bufs = list(dec._staging.buffers.values())
    assert len(bufs) == 2 and all(b.pinned for b in bufs)
    assert all(torch.from_numpy(p).is_pinned() for b in bufs for p in b.planes)
    base = bufs[0].base
    assert staging.page_lock(base, cuda) is None  # registered already
    assert torch.equal(torch.ones(2, device=cuda) * 2,
                       torch.full((2,), 2.0, device=cuda))
    dec.close()
    assert not torch.from_numpy(base).is_pinned()


@pytest.mark.parametrize("hybrid", [False, True])
def test_corpus_results_come_down_page_locked_on_card(cuda, hybrid):
    """After a warm-up call, every K1 frame's RGB comes down by DMA into a
    page-locked result buffer: ``pinned_rgb_frames`` counts every frame,
    ``decode.crop_d2h``'s ``pinned_bytes`` are all its ``bytes``, the
    profiler's trace names the downloads ``Memcpy DtoH (Device ->
    Pinned)``, one a K1 launch (on the host route the only DtoH copies of
    the call; a warm call may stream runs, so it launches once a bucket
    or more), and the results equal the CPU's."""
    from jpeg_tpu_torch.utils import profiling

    items = [_read(SMALL[0])] * 12 + [_read(SMALL[2])] * 3  # two geometries
    dec = BatchedCorpusDecoder(workers=2, hybrid_device=hybrid,
                               device_batch=2, device=cuda)
    dec.decode_all(items)  # builds the kernels and the buffers
    before, launches = dec.pinned_rgb_frames, dec.pixel_launches
    calls = {c.id for c in profiling.recorded_calls()}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = dec.decode_all(items)
    assert dec.pinned_rgb_frames - before == len(items)
    (call,) = [c for c in profiling.recorded_calls() if c.id not in calls]
    crops = [s.counts for s in profiling.recorded_spans([call.id])
             if s.name == "decode.crop_d2h"]
    assert len(crops) == dec.pixel_launches - launches >= 2
    assert (sum(c["pinned_bytes"] for c in crops)
            == sum(c["bytes"] for c in crops)
            == sum(r.rgb.nbytes for r in got))
    d2h = [e.name() for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA
           and e.name().startswith("Memcpy DtoH")]
    assert d2h.count("Memcpy DtoH (Device -> Pinned)") >= len(crops)
    if not hybrid:
        assert d2h == ["Memcpy DtoH (Device -> Pinned)"] * len(crops), d2h
    for data, r in zip(items, got):
        np.testing.assert_array_equal(
            r.rgb, decode_bytes(data, path="fast", device="cpu"))
    pools = list(dec._staging.rgb.values())
    assert len(pools) == 2 and all(len(p) == 1 and p[0].pinned for p in pools)
    assert all(torch.from_numpy(p[0].array).is_pinned() for p in pools)
    dec.close()


def _image(width, height, seed):
    """Smooth colour fields plus noise, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    img = np.stack([128 + 80 * np.sin(xx / 17.0 + seed) * np.cos(yy / 11.0),
                    128 + 80 * np.sin(xx / 9.0) * np.cos(yy / 23.0 + seed),
                    128 + 80 * np.cos(xx / 31.0 + yy / 7.0)], axis=-1)
    img += rng.normal(0, 6.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


K2_CASES = {"4:2:0": (2, 2), "4:4:4": (1, 1), "gray": None}


@pytest.mark.parametrize("name", K2_CASES)
def test_k2_kernel_equals_plain(cuda, name):
    """Same fp32 operations in the same order: identical coefficients; the
    launch counter moves by exactly one per call."""
    sub = K2_CASES[name]
    img = _image(300, 77, seed=len(name))
    if sub is None:
        img = img[..., 0]
    geom, planar, iq, _ = encoder.device_inputs(img, 85, sub or (1, 1),
                                                sub is None)
    rgb = torch.from_numpy(np.stack([planar] * 2)).to(cuda)
    iqt = torch.from_numpy(np.stack([iq] * 2)).to(cuda)
    before = k2.LAUNCHES.value
    got = k2.fused_plane_encode(rgb, iqt, geom)
    assert k2.LAUNCHES.value == before + 1
    again = k2.fused_plane_encode(rgb, iqt, geom)
    assert k2.LAUNCHES.value == before + 2
    want = k2.fused_plane_encode_plain(rgb, iqt, geom)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("sampling", K1_SAMPLINGS)
def test_k2_kernel_equals_plain_every_sampling(cuda, sampling, batch):
    """Every sampling K2 takes (luma h, v in 1, 2, 4 over 1x1 chroma, and
    gray), seeded images of an odd size so the padded tiles and bands are
    partly edge fill: identical planes."""
    sub = K1_SAMPLINGS[sampling]
    parts = []
    for seed in range(batch):
        img = _image(520, 200, seed + 3)
        parts.append(encoder.device_inputs(
            img[..., 0] if sub is None else img, 80 + seed, sub or (1, 1),
            sub is None))
    geom = parts[0][0]
    rgb = torch.from_numpy(np.stack([p[1] for p in parts])).to(cuda)
    iqt = torch.from_numpy(np.stack([p[2] for p in parts])).to(cuda)
    before = k2.LAUNCHES.value
    got = k2.fused_plane_encode(rgb, iqt, geom)
    assert k2.LAUNCHES.value == before + 1
    want = k2.fused_plane_encode_plain(rgb, iqt, geom)
    assert len(got) == len(want) == len(geom.sampling)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k2_kernel_equals_plain_on_unusual_geometry(cuda):
    """Luma at half height and Cb, Cr sampled unlike each other: the kernel
    compiled for any box factors (the usual ones have kernels of their own)."""
    geom = PipelineGeometry(width=520, height=200, mcus_x=33, mcus_y=13,
                            h_max=2, v_max=2,
                            sampling=((2, 1), (1, 2), (1, 1)))
    rng = np.random.default_rng(8)
    rgb = torch.from_numpy(rng.integers(
        0, 256, (2, 3, *k1.padded_size(geom)), dtype=np.uint8)).to(cuda)
    iqt = torch.from_numpy((1.0 / rng.integers(1, 64, (2, 3, 64)))
                           .astype(np.float32)).to(cuda)
    got = k2.fused_plane_encode(rgb, iqt, geom)
    want = k2.fused_plane_encode_plain(rgb, iqt, geom)
    assert [tuple(g.shape) for g in got] == [(2, 128, 768), (2, 256, 384),
                                             (2, 128, 384)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kwargs", [
    dict(subsampling=(2, 2), restart_interval_mcus=2),
    dict(subsampling=(1, 1), quality=95),
    dict(grayscale=True, restart_interval_mcus=3, optimize=True),
])
def test_encode_rgb_device_cuda_bytes_equal_cpu(cuda, kwargs):
    img = _image(200, 120, seed=7)
    if kwargs.get("grayscale"):
        img = img[..., 0]
    assert (encode_rgb_device(img, device=cuda, **kwargs)
            == encode_rgb_device(img, device="cpu", **kwargs))


def _idct_plane(shape, zeros, pattern, seed):
    """A seeded int16 plane with a share of zero coefficients, and a tiled
    or an arbitrary (not periodic, signed) dequant pattern."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-512, 512, shape).astype(np.int16)
    x[rng.random(shape) < zeros] = 0
    if pattern == "tiled":
        qpat = k56.quant_pattern(np.arange(1, 65), 128, 256)
    else:
        qpat = rng.uniform(-4.0, 64.0, (128, 256)).astype(np.float32)
        qpat[rng.random((128, 256)) < 0.05] = 0.0
    return torch.from_numpy(x), torch.from_numpy(qpat)


@pytest.mark.parametrize("pattern", ["tiled", "random"])
@pytest.mark.parametrize("zeros", [0.8, 1.0])
@pytest.mark.parametrize("shape", [(128, 256), (512, 768)])
@pytest.mark.parametrize("kernel", ["K5", "K6"])
def test_k5_k6_kernels_equal_plain_bit_for_bit(cuda, kernel, shape, zeros,
                                               pattern):
    """One templated body, two sums: each kernel gives its own twin's bits,
    the sign of every zero included."""
    x, qpat = (t.to(cuda) for t in _idct_plane(shape, zeros, pattern,
                                                 seed=shape[0] + int(zeros * 10)))
    build, plain = {"K5": (k56.idct_only_kernel, k56.idct_only_plain),
                    "K6": (k56.idct_only_kernel_roll, k56.idct_only_roll_plain)}[kernel]
    got = build(*shape)(x, qpat)
    assert torch.equal(got.view(torch.int32), plain(x, qpat).view(torch.int32))


def test_k5_k6_kernels_keep_the_sign_of_zero(cuda):
    """Zero coefficients under a negative pattern: K5 gives -0 at each
    block's first pixel, as its twin does, and K6 +0 everywhere."""
    x = torch.zeros((128, 256), dtype=torch.int16, device=cuda)
    qpat = torch.full((128, 256), -1.0, dtype=torch.float32, device=cuda)
    k5 = k56.idct_only_kernel(128, 256)(x, qpat)
    k6 = k56.idct_only_kernel_roll(128, 256)(x, qpat)
    assert bool(torch.signbit(k5[::8, ::8]).all())
    assert not bool(torch.signbit(k6).any())
    assert torch.equal(k5.view(torch.int32),
                       k56.idct_only_plain(x, qpat).view(torch.int32))


@pytest.mark.parametrize("h_max,v_max,sampling", [
    (1, 3, ((1, 3), (1, 1), (1, 1))),
    (3, 1, ((3, 1), (2, 1), (2, 1))),
    (2, 2, ((2, 2), (1, 0), (1, 1))),
])
def test_k1_launcher_refuses_factors_it_does_not_take(cuda, h_max, v_max,
                                                      sampling):
    """Called directly, past the wrapper's checks, K1's launcher returns
    cudaErrorInvalidValue (1) for a factor of 3 or one that does not
    divide, as K2's does, and launches nothing."""
    import ctypes

    n = len(sampling)
    planes = [torch.zeros((1, 128, 256), dtype=torch.int16, device=cuda)
              for _ in range(n)]
    qt = torch.ones((1, n, 64), dtype=torch.float32, device=cuda)
    out = torch.zeros((1, 3, 128, 256), dtype=torch.uint8, device=cuda)
    basis = np.ascontiguousarray(k1.dct_basis_1d(), np.float32)
    rc = k1.load_kernel().jt_fused_plane_decode(
        (ctypes.c_void_p * n)(*[p.data_ptr() for p in planes]),
        (ctypes.c_int64 * n)(*[128] * n), (ctypes.c_int64 * n)(*[256] * n),
        (ctypes.c_int32 * n)(*[h for h, _ in sampling]),
        (ctypes.c_int32 * n)(*[v for _, v in sampling]),
        n, h_max, v_max, 1, qt.data_ptr(),
        basis.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.data_ptr(),
        1, 128, 256, 0, 0, torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert rc == 1
    assert not bool(out.any())


@pytest.mark.parametrize("name", SMALL)
def test_compat_default_on_card_within_one(cuda, name):
    """decode_bytes' default (compat) route with its product on the card:
    within +-1 u8 of the same route on the CPU and of the fast path."""
    data = _read(name)
    got = decode_bytes(data, device=cuda)
    for want in (decode_bytes(data, device="cpu"),
                 decode_bytes(data, path="fast", device=cuda)):
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


K1_ROUTE_NEW = ["synth_3840x2160_s5_q85_rst0_prog.jpg",
                "synth_3840x2160_s6_q85_rst1_sof9.jpg",
                "synth_512x384_s7_q85_rst0_sof10.jpg",
                "synth_512x384_s12_q85_rst0_gray_prog.jpg"]
COMPAT_ROUTE_NEW = ["synth_512x384_s8_q85_rst0_cmyk.jpg",
                    "synth_512x384_s9_q85_rst0_cmyk_prog.jpg",
                    "synth_512x384_s10_q85_rst0_ycck.jpg",
                    "synth_512x384_s11_q85_rst0_rgb.jpg"]


@pytest.mark.parametrize("name", K1_ROUTE_NEW)
def test_k1_route_of_progressive_and_arithmetic_streams(cuda, name):
    """Progressive and arithmetic streams through decode_bytes(path='fast')
    on the card: one K1 launch, pixels equal to the CPU route bit for bit
    (the same C++ entropy planes into a kernel bit-identical to its twin)."""
    data = _read(name)
    before = k1.LAUNCHES.value
    got = decode_bytes(data, path="fast", device=cuda)
    assert k1.LAUNCHES.value == before + 1
    np.testing.assert_array_equal(got, decode_bytes(data, path="fast",
                                                    device="cpu"))


@pytest.mark.parametrize("name", COMPAT_ROUTE_NEW)
def test_compat_route_colour_models_on_card(cuda, name):
    """CMYK, YCCK and RGB-direct streams take the compat route on either
    path, no K1 launch: within +-1 u8 of the CPU."""
    data = _read(name)
    before = k1.LAUNCHES.value
    got = decode_bytes(data, path="fast", device=cuda)
    assert k1.LAUNCHES.value == before
    np.testing.assert_array_equal(got, decode_bytes(data, device=cuda))
    want = decode_bytes(data, device="cpu")
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _k1_batch(sub, cuda):
    """Two seeded 520x200 images at one sampling, as K1's inputs on ``cuda``."""
    plans = []
    for seed in (1, 2):
        img = _image(520, 200, seed)
        data = (encode_rgb(img[..., 0], quality=90, grayscale=True) if sub is None
                else encode_rgb(img, quality=90, subsampling=sub))
        plans.append(parse_jpeg(data))
    geom = PipelineGeometry.of(plans[0])
    host = [native_decode_planes(p) for p in plans]
    planes = [torch.from_numpy(np.stack([h[c] for h in host])).to(cuda)
              for c in range(len(host[0]))]
    qt = torch.from_numpy(np.stack(
        [k1.plan_quant_patterns(p, geom) for p in plans])).to(cuda)
    return planes, qt, geom


# K1a against its plain twin: the tensor cores sum the exact bf16 products
# in their own order, a few fp32 ulps from the twin's sum rounded after each
# term; rarely that moves a value of T across a bf16 rounding point or a
# pixel across a u8 boundary, so K1a equals its twin to a tolerance: max
# |diff| <= 2 u8, at most 1e-3 of the values differing, every frame
# >= 70 dB. A wrong basis, rounding mode or pair packing changes percents
# of the values.
K1A_TWIN_MAX_DIFF = 2
K1A_TWIN_MAX_SHARE = 1e-3
K1A_TWIN_MIN_PSNR = 70.0


def _psnr(a, b) -> float:
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _within_twin_tolerance(frames, twins):
    """K1a's frames against the twin's: max |diff|, share of values
    differing and every frame's PSNR inside the order-of-sums tolerance."""
    diff = [np.abs(f.astype(int) - t.astype(int)) for f, t in zip(frames, twins)]
    assert max(int(d.max()) for d in diff) <= K1A_TWIN_MAX_DIFF
    assert (sum(int((d != 0).sum()) for d in diff)
            <= K1A_TWIN_MAX_SHARE * sum(d.size for d in diff))
    assert min(_psnr(f, t) for f, t in zip(frames, twins)) >= K1A_TWIN_MIN_PSNR


@pytest.mark.parametrize("rounding", ["truncate", "round"])
@pytest.mark.parametrize("sampling", K1_SAMPLINGS)
def test_k1a_kernel_equals_plain_every_sampling(cuda, sampling, rounding):
    """K1a, the approx tier, on the tensor cores: within the order-of-sums
    tolerance of its twin on every frame; it counts its own launches, not
    K1's."""
    planes, qt, geom = _k1_batch(K1_SAMPLINGS[sampling], cuda)
    before, before_k1 = k1.LAUNCHES_APPROX.value, k1.LAUNCHES.value
    got = k1.fused_plane_decode(planes, qt, geom, rounding, "approx")
    assert k1.LAUNCHES_APPROX.value == before + 1
    assert k1.LAUNCHES.value == before_k1
    want = k1.fused_plane_decode_plain(planes, qt, geom, rounding, "approx")
    _within_twin_tolerance(list(got.cpu().numpy()), list(want.cpu().numpy()))


@pytest.mark.parametrize("rounding", ["truncate", "round"])
@pytest.mark.parametrize("sampling", K1_SAMPLINGS)
def test_k1_still_equals_plain_beside_k1a(cuda, sampling, rounding):
    """Exact K1, launched in the same process right after K1a on the same
    inputs, stays bit-equal to its twin: the tensor-core tier shares the
    kernel's code and leaves K1's arithmetic alone."""
    planes, qt, geom = _k1_batch(K1_SAMPLINGS[sampling], cuda)
    k1.fused_plane_decode(planes, qt, geom, rounding, "approx")
    before = k1.LAUNCHES.value
    got = k1.fused_plane_decode(planes, qt, geom, rounding)
    assert k1.LAUNCHES.value == before + 1
    assert torch.equal(got, k1.fused_plane_decode_plain(planes, qt, geom, rounding))


def test_k1a_within_gate_of_k1_on_4k_frame(cuda):
    """docs/APPROX_QUALITY.md's gate against exact K1 on the main path's
    frame: max |diff| <= 2 u8, >= 50 dB; and through ``decode_bytes`` on
    the card within the order-of-sums tolerance of the CPU (the twin)."""
    data = _read("synth_3840x2160_s0_q85_rst1.jpg")
    approx = decode_bytes(data, path="fast", idct_mode="approx", device=cuda)
    exact = decode_bytes(data, path="fast", device=cuda)
    diff = np.abs(approx.astype(float) - exact.astype(float))
    assert diff.max() <= 2 and 10 * np.log10(255.0**2 / (diff**2).mean()) >= 50
    _within_twin_tolerance([approx], [decode_bytes(
        data, path="fast", idct_mode="approx", device="cpu")])


def test_approx_corpus_on_card(cuda):
    """BatchedCorpusDecoder(idct_mode="approx") on the card, hybrid: each
    frame within the order-of-sums tolerance of the single-image approx
    decode on the CPU, through K1a."""
    items = [_read(n) for n in SMALL] * 3
    before = k1.LAUNCHES_APPROX.value
    dec = BatchedCorpusDecoder(hybrid_device=True, device_batch=2,
                               idct_mode="approx", device=cuda)
    got = dec.decode_all(items)
    dec.close()
    assert k1.LAUNCHES_APPROX.value > before
    assert all(r.ok for r in got)
    _within_twin_tolerance([r.rgb for r in got], [decode_bytes(
        data, path="fast", idct_mode="approx", device="cpu") for data in items])


def _twelve_bit_stream(kind, sub=(2, 2)):
    rng = np.random.default_rng(40)
    img = rng.integers(0, 4096, (96, 128, 3)).astype(np.uint16)
    if kind == "sof2":
        return encoder.encode_rgb_progressive(img, subsampling=sub,
                                              precision=12)
    return encode_rgb(img, subsampling=sub, precision=12,
                      arithmetic=kind == "sof9")


def test_uint16_narrowing_on_card(cuda):
    """The one u16 operation the 12-bit and lossless routes run on the card,
    ``.to(torch.uint16)``, and its copy to the host."""
    from jpeg_tpu_torch.ops.color import quantize_samples

    x = torch.linspace(-50.0, 4200.0, 10007)
    for rounding in ("truncate", "round"):
        got = quantize_samples(x.to(cuda), rounding, 4095)
        assert got.dtype == torch.uint16
        assert torch.equal(got.cpu(), quantize_samples(x, rounding, 4095))
        assert torch.equal(got.view(-1, 1).expand(-1, 3).cpu(),
                           quantize_samples(x, rounding, 4095)
                           .view(-1, 1).expand(-1, 3))


@pytest.mark.parametrize("kind", ["sof1", "sof9", "sof2"])
def test_twelve_bit_decode_on_card(cuda, kind):
    """12-bit frames through the compat route on the card: u16 within +-1
    of the CPU run on every sampling K1 does not take."""
    for sub in ((1, 1), (2, 1), (2, 2)):
        data = _twelve_bit_stream(kind, sub)
        got = decode_bytes(data, device=cuda)
        want = decode_bytes(data, device="cpu")
        assert got.dtype == want.dtype == np.uint16
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert np.array_equal(decode_bytes(data, path="fast", device=cuda), got)


@pytest.mark.parametrize("predictor", [1, 2])
def test_reconstruct_device_on_card(cuda, predictor):
    """``reconstruct_device`` (two ``torch.cumsum`` mod 2^16) on the card
    equals its CPU run and the sequential reconstruction, with a point
    transform and 16-bit samples; ``decode_bytes`` too."""
    from jpeg_tpu_torch.entropy import lossless

    rng = np.random.default_rng(predictor)
    img = rng.integers(0, 65536, (40, 56, 3)).astype(np.uint16)
    data = lossless.encode_lossless(img, predictor=predictor,
                                    point_transform=3, precision=16)
    plan = parse_jpeg(data)
    diffs = lossless.decode_diffs(plan)
    got = lossless.reconstruct_device(plan, diffs, cuda)
    assert got.device.type == cuda.type and got.dtype == torch.uint16
    np.testing.assert_array_equal(
        got.cpu().numpy(), lossless.reconstruct_device(plan, diffs, "cpu").numpy())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  lossless.reconstruct(plan, diffs))
    np.testing.assert_array_equal(decode_bytes(data, device=cuda),
                                  (img >> 3) << 3)


@pytest.mark.parametrize("predictor", [1, 5])
def test_decode_lossless_bare_call_on_card(cuda, predictor, monkeypatch):
    """A bare ``decode_lossless(plan)`` runs on the card: the C++
    differences and the cumsum there for predictor 1, ``jt_decode_lossless``
    for predictor 5; never the pure-Python difference decoder."""
    from jpeg_tpu_torch.entropy import lossless

    img = np.random.default_rng(predictor).integers(
        0, 256, (48, 64, 3)).astype(np.uint8)
    plan = parse_jpeg(lossless.encode_lossless(img, predictor=predictor))
    devices = []
    real = lossless.reconstruct_device
    monkeypatch.setattr(lossless, "decode_diffs", None)
    monkeypatch.setattr(lossless, "reconstruct_device",
                        lambda p, d, dev: devices.append(dev) or real(p, d, dev))
    np.testing.assert_array_equal(lossless.decode_lossless(plan), img)
    assert devices == (["cuda"] if predictor == 1 else [])


def test_k3_names_on_card(cuda):
    """Every device-entropy tier name launches K3 once and equals the v5
    name on the card and the CPU run, bit for bit."""
    from jpeg_tpu_torch.entropy import device_decode2 as v2
    from jpeg_tpu_torch.entropy import device_window as v5

    base = parse_jpeg(_read(SMALL[0]))
    plans = [base, parse_jpeg(_read(SMALL[0]))]
    want, werr = v5.decode_coefficients_device5_batch(plans, cuda,
                                                      to_host=False)
    cpu, cerr = v1.decode_coefficients_device_batch(plans, device="cpu")
    assert torch.equal(werr.cpu(), cerr)
    assert all(torch.equal(w.cpu(), c) for w, c in zip(want, cpu))

    def window():
        run, args, _meta = v5.window_runner_batch(plans, cuda)
        coeffs, err = run(*args)
        b = k3.prepare_lane_batch(plans)
        return [coeffs[r0 : r0 + n] for r0, n in b.images], err

    calls = [lambda: v1.decode_coefficients_device(base, device=cuda),
             lambda: v1.decode_coefficients_device_batch(plans, device=cuda),
             lambda: v2.decode_coefficients_device2(base, device=cuda),
             lambda: v2.decode_coefficients_device3(base, device=cuda),
             lambda: v2.decode_coefficients_device2_batch(plans, device=cuda),
             window]
    for call in calls:
        before = k3.LAUNCHES.value
        coeffs, err = call()
        assert k3.LAUNCHES.value == before + 1
        coeffs = coeffs if isinstance(coeffs, list) else [coeffs]
        assert err.device.type == cuda.type
        assert torch.equal(err, werr[: err.numel()])
        assert all(torch.equal(c, w) for c, w in zip(coeffs, want))


def _k7_against_plain(plan, lanes, overlap, dev):
    """K7 and its plain twin on the same lanes: every element of the four
    outputs equal, one launch counted."""
    ls, ce, se, groups = k7._chunk_lanes(plan, lanes)
    cap = k7.spec_cap(groups, overlap)
    t = k7.spec_tensors(plan, ls, ce, se, dev, tables="both")
    before = k7.LAUNCHES.value
    got = k7.spec_lanes(t, len(plan.scan_data), cap, overlap,
                        len(plan.components))
    assert k7.LAUNCHES.value == before + 1
    want = k7.spec_lanes_plain(t, len(plan.scan_data), cap, overlap,
                               len(plan.components))
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g, w)


@pytest.mark.parametrize("name,lanes,overlap", [
    (SMALL[1], 64, 24), (SMALL[1], 64, 2), (SMALL[0], 64, 4),
    (SMALL[2], 32, 3)])
def test_k7_kernel_equals_plain_and_cpp(cuda, name, lanes, overlap):
    """Phase A bit for bit with its twin; the whole speculative decode,
    the coefficients on the card, bit for bit with the C++ decoder."""
    plan = parse_jpeg(_read(name))
    _k7_against_plain(plan, lanes, overlap, cuda)
    coeffs, stats = k7.decode_coefficients_device_spec(plan, lanes, overlap,
                                                       device=cuda)
    assert stats["failed"] == 0 and coeffs.device.type == "cuda"
    np.testing.assert_array_equal(coeffs.cpu().numpy(),
                                  native_decode_coefficients(plan))


@pytest.mark.parametrize("seed", [5, 12])
def test_k7_reads_fill_past_a_damaged_segment_end(cuda, seed):
    """F8 on the card: the fuzz's damaged restart stream whose last MCU of a
    segment decodes past the segment's end. K7 reads 0xAA fill there, as
    its twin and the C++ decoder do, so the merge equals the C++ decoder."""
    from jpeg_tpu_torch.io.corpus import synthetic_image
    from jpeg_tpu_torch.tools.fuzz import corrupt

    data = corrupt("rst", encode_rgb(synthetic_image(144, 96, seed=1),
                                     quality=80, restart_interval_mcus=3),
                   seed)
    plan = parse_jpeg(data)
    _k7_against_plain(plan, 64, 24, cuda)
    coeffs, stats = k7.decode_coefficients_device_spec(plan, 64, 24,
                                                       device=cuda)
    assert stats["failed"] == 0
    np.testing.assert_array_equal(
        coeffs.cpu().numpy(),
        native_decode_coefficients(plan, reuse_buffer=False))


@pytest.mark.parametrize("seed", range(4))
def test_k7_kernel_equals_plain_on_corrupt_streams(cuda, seed):
    """Flipped bytes: lanes die at invalid prefixes, K7 as its twin does."""
    plan = parse_jpeg(_read(SMALL[1]))
    rng = np.random.default_rng(seed)
    pos = rng.choice(len(plan.scan_data), size=3, replace=False)
    plan.scan_data[pos] ^= rng.integers(1, 256, size=3).astype(np.uint8)
    _k7_against_plain(plan, 48, 4, cuda)



@pytest.mark.parametrize("kernel", ["K3", "K4", "K7"])
def test_two_sentinels_on_damaged_lanes(cuda, kernel):
    """Every entry a consumer reads is written by the kernel: run over the
    fuzz's damaged cases (seeds 0-2) with the module's torch.empty outputs
    pre-filled by two different bytes, the read entries are equal."""
    from jpeg_tpu_torch.tools import sentinel

    rec = sentinel.check(cuda, range(3), (kernel,))[kernel]
    assert rec["cases"] > 0 and rec["launches"] >= 2 * rec["cases"], rec
    assert rec["read_differ"] == [], rec
