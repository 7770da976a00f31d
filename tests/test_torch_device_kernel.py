"""K4 (word-column device entropy) plain version vs jpeg_tpu's in-kernel
Pallas decoder (interpret mode) vs the NumPy oracle: bit for bit, error
vectors and flagged lanes included; the host preparation held to the
original array by array; and the single-frame device-entropy decode
(K4 -> planes -> K1) against ``decode_bytes``."""

import os

import numpy as np
import pytest
import torch

from jpeg_tpu.entropy import device_kernel as jk4
from jpeg_tpu.entropy.oracle import decode_coefficients
from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu.models.encoder import encode_rgb
from jpeg_tpu_torch.entropy import device_kernel as k4
from jpeg_tpu_torch.entropy.device_decode import decode_coefficients_device_batch
from jpeg_tpu_torch.io.container import parse_jpeg, plan_from_reference

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens", "torch")


def _plans(seed, n, shape=(48, 64), gray=False, **enc):
    rng = np.random.default_rng(seed)
    refs = []
    for _ in range(n):
        hi = 4096 if enc.get("precision") == 12 else 256
        img = rng.integers(0, hi, (*shape, 3),
                           dtype=np.uint16 if hi > 256 else np.uint8)
        refs.append(ref_parse(encode_rgb(img[..., 0] if gray else img,
                                         grayscale=gray, **enc)))
    return refs


def _port(refs):
    return [plan_from_reference(p) for p in refs]


def _corrupt(refs, seed):
    """Seeded byte flips in each plan's scan, except in the first plan's
    second segment, which gets 64 one-bits in its middle instead: an invalid
    prefix whatever precedes it, so that lane (lane 1) is flagged after it
    decoded some blocks."""
    rng = np.random.default_rng(seed)
    for i, p in enumerate(refs):
        scan = p.scan_data.copy()
        allowed = np.ones(len(scan), bool)
        if i == 0:
            s = p.segments[1]
            allowed[s.byte_start : s.byte_end] = False
        pos = rng.choice(np.flatnonzero(allowed), size=1 + seed % 3,
                         replace=False)
        scan[pos] ^= rng.integers(1, 256, size=len(pos)).astype(np.uint8)
        p.scan_data = scan
    s = refs[0].segments[1]
    mid = (s.byte_start + s.byte_end) // 2
    refs[0].scan_data[mid : mid + 8] = 0xFF
    return refs


def _single(ref, gather="select"):
    """(port coeffs, port err, jax coeffs, jax err) for one plan."""
    got, err = k4.decode_coefficients_device4(plan_from_reference(ref),
                                              device="cpu", gather=gather)
    want, want_err = jk4.decode_coefficients_device4(ref, interpret=True)
    return got, err, np.asarray(want), np.asarray(want_err)


@pytest.mark.parametrize("sub,gray,ri", [
    ((1, 1), False, 4), ((2, 1), False, 3), ((2, 2), False, 2),
    ((1, 2), False, 3), ((1, 1), True, 6)])
def test_matches_jax_and_oracle(sub, gray, ri):
    ref = _plans(hash((sub, gray, "k4")) % 2**31, 1, gray=gray, quality=85,
                 subsampling=sub, restart_interval_mcus=ri)[0]
    got, err, want, want_err = _single(ref)
    assert got.dtype == np.int32 and got.shape == (ref.total_blocks, 64)
    assert err.shape == (len(ref.segments),)
    assert not err.any() and not want_err.any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, decode_coefficients(ref))


@pytest.mark.parametrize("case", ["single_lane", "long_codes", "12bit"])
def test_special_streams(case):
    """One lane with no restarts; optimized tables with 12-16-bit codes (the
    canonical walk); SOF1 12-bit magnitudes (> 11 bits)."""
    if case == "single_lane":
        ref = _plans(3, 1, quality=85, subsampling=(2, 2))[0]
        assert len(ref.segments) == 1
    elif case == "long_codes":
        ref = _plans(4, 1, shape=(80, 80), quality=92, subsampling=(2, 2),
                     restart_interval_mcus=5, optimize=True)[0]
        assert max(int(t.lengths.max()) for t in ref.ac_tables
                   if len(t.lengths)) >= 12
    else:
        ref = _plans(5, 1, quality=97, subsampling=(1, 1), precision=12,
                     engine="python", restart_interval_mcus=3)[0]
        assert ref.precision == 12
    got, err, want, want_err = _single(ref)
    assert not err.any() and not want_err.any()
    np.testing.assert_array_equal(got, want)
    oracle = decode_coefficients(ref)
    np.testing.assert_array_equal(got, oracle)
    if case == "12bit":
        assert int(np.abs(oracle).max()) > 2047


@pytest.mark.parametrize("seed", range(4))
def test_corrupt_streams_bit_exact(seed):
    """Seeded corruption, one launch over three images: error vectors and
    every coefficient, flagged lanes included, equal the JAX kernel's;
    unflagged lanes equal the oracle."""
    refs = _corrupt(_plans(300 + seed, 3, quality=85, subsampling=(2, 2),
                           restart_interval_mcus=2), 400 + seed)
    got, err = k4.decode_coefficients_device4_batch(_port(refs), device="cpu")
    want, want_err = jk4.decode_coefficients_device4_batch(refs, interpret=True)
    np.testing.assert_array_equal(err, np.asarray(want_err))
    assert err[1]
    lane = 0
    for g, w, p in zip(got, want, refs):
        np.testing.assert_array_equal(g, np.asarray(w))
        flags = err[lane : lane + len(p.segments)]
        lane += len(p.segments)
        try:
            ref = decode_coefficients(p)
        except ValueError:
            assert flags.any()
            continue
        bpm = p.blocks_per_mcu
        for s, bad in zip(p.segments, flags):
            r0, r1 = s.mcu_start * bpm, (s.mcu_start + s.mcu_count) * bpm
            if not bad:
                np.testing.assert_array_equal(g[r0:r1], ref[r0:r1])


def test_cut_lane_reads_zeros_past_w():
    """A single lane cut to a third runs past its word column: K4 reads
    zeros there (K3 reads 0xAA forever), so its flagged garbage is its own
    and equals the JAX kernel's, not K3's."""
    ref = _plans(7, 1, shape=(64, 80), quality=85, subsampling=(1, 1))[0]
    s = ref.segments[0]
    s.byte_end = s.byte_start + (s.byte_end - s.byte_start) // 3
    got, err, want, want_err = _single(ref)
    assert err[0] and want_err[0]
    np.testing.assert_array_equal(got, want)
    k3, k3_err = decode_coefficients_device_batch(_port([ref]), device="cpu")
    assert k3_err[0] and not np.array_equal(k3[0].numpy(), got)


def test_batch_mixed_restart_intervals():
    """Three images with different restart intervals in one launch: each is
    trimmed segment by segment and equals its oracle and the JAX batch."""
    rng = np.random.default_rng(60)
    refs = []
    for shape, ri in [((48, 64), 4), ((80, 96), 8), ((64, 48), 2)]:
        img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        refs.append(ref_parse(encode_rgb(img, quality=85, subsampling=(2, 2),
                                         restart_interval_mcus=ri)))
    got, err = k4.decode_coefficients_device4_batch(_port(refs), device="cpu")
    want, want_err = jk4.decode_coefficients_device4_batch(refs, interpret=True)
    assert not err.any() and not np.asarray(want_err).any()
    assert len(got) == len(refs)
    for g, w, p in zip(got, want, refs):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, decode_coefficients(p))


def test_batch_to_device_keeps_tensors():
    refs = _plans(61, 2, quality=85, restart_interval_mcus=3)
    got, err = k4.decode_coefficients_device4_batch(_port(refs), device="cpu",
                                                    to_host=False)
    assert isinstance(err, torch.Tensor) and err.dtype == torch.bool
    assert all(isinstance(g, torch.Tensor) and g.dtype == torch.int32
               for g in got)
    host, host_err = k4.decode_coefficients_device4_batch(_port(refs),
                                                          device="cpu")
    np.testing.assert_array_equal(err.numpy(), host_err)
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g.numpy(), h)


def test_single_to_device_keeps_tensors():
    ref = _plans(62, 1, quality=85, restart_interval_mcus=2)[0]
    got, err = k4.decode_coefficients_device4(plan_from_reference(ref),
                                              device="cpu", to_host=False)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    assert isinstance(err, torch.Tensor) and err.dtype == torch.bool
    host, host_err = k4.decode_coefficients_device4(plan_from_reference(ref),
                                                    device="cpu")
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(err.numpy(), host_err)


@pytest.mark.parametrize("runner", ["single", "batch"])
def test_raw_runner_outputs_equal_jax_kernel(runner):
    """``run(*args)`` returns the TPU kernel's raw [max_mcus, bpm, 64, S]
    coefficients and [1, S] flags, with each runner's own W bucketing."""
    refs = _corrupt(_plans(70, 2, quality=85, subsampling=(2, 1),
                           restart_interval_mcus=3), 71)
    if runner == "single":
        run, args, mm, S = k4.kernel_runner(_port(refs)[0], device="cpu")
        jrun, jargs, jmm, jS = jk4.kernel_runner(refs[0], interpret=True)
    else:
        run, args, mm, S, base = k4.kernel_runner_batch(_port(refs), device="cpu")
        jrun, jargs, jmm, jS, jbase = jk4.kernel_runner_batch(refs,
                                                              interpret=True)
        assert base == jbase
    assert (mm, S) == (jmm, jS)
    for a, j in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    out, err = run(*args)
    jout, jerr = jrun(*jargs)
    assert out.dtype == torch.int32 and err.dtype == torch.bool
    assert tuple(err.shape) == (1, S)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    assert err.any()


@pytest.mark.parametrize("gather", ["select", "mxu"])
def test_gather_modes_same_result(gather):
    ref = _plans(50, 1, shape=(80, 96), quality=88, subsampling=(2, 2),
                 restart_interval_mcus=5, optimize=True)[0]
    got, err, want, want_err = _single(ref, gather)
    assert not err.any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, decode_coefficients(ref))


@pytest.mark.parametrize("gather", ["select", "mxu"])
def test_plan_kernel_tables_match_jax(gather):
    ref = _plans(8, 1, quality=90, subsampling=(2, 2), optimize=True,
                 restart_interval_mcus=3)[0]
    lut, hv, canon = k4.plan_kernel_tables(plan_from_reference(ref), gather)
    jl, jh, jc = jk4.plan_kernel_tables(ref, gather)
    for a, b in ((lut, jl), (hv, jh)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert canon == jc


def test_lane_words_and_plan_w_match_jax():
    ref = _plans(9, 1, shape=(64, 80), quality=85, restart_interval_mcus=2)[0]
    for w in (8 + len(ref.scan_data) // 4, 256):
        got = k4._lane_words(ref.scan_data, plan_from_reference(ref).segments, w)
        want = jk4._lane_words(ref.scan_data, ref.segments, w)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert k4._plan_w(plan_from_reference(ref)) == jk4._plan_w(ref)


def test_batch_rejects_mixed_tables_before_launch():
    a = _plans(61, 1, quality=85, restart_interval_mcus=4)[0]
    b = _plans(61, 1, quality=85, restart_interval_mcus=4, optimize=True)[0]
    with pytest.raises(ValueError, match="identical slot structure"):
        k4.kernel_runner_batch(_port([a, b]), device="cpu")


def test_refusals():
    """The meta device, an unknown gather and a hand-built DC table whose
    symbols exceed 16 (the register shifts at most 32 bits) are refused."""
    plan = _port(_plans(62, 1, quality=85, restart_interval_mcus=4))[0]
    run, args, _, _ = k4.kernel_runner(plan, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        run(*args)
    with pytest.raises(ValueError, match="gather"):
        k4.kernel_runner(plan, device="cpu", gather="kron")
    plan.dc_tables[0].values = np.array([17], np.uint8)
    with pytest.raises(ValueError, match="> 16"):
        k4.kernel_runner(plan, device="cpu")


@pytest.mark.parametrize("name", ["synth_512x384_s2_q85_rst1.jpg",
                                  "synth_512x384_s4_q85_rst1_gray.jpg"])
def test_single_frame_device_entropy_decode(name):
    """The slice as a whole on the CPU: K4 -> coefficient planes -> K1
    equals ``decode_bytes(path="fast")`` (host C++ entropy + K1)."""
    from jpeg_tpu_torch.models.decoder import (
        PipelineGeometry,
        coefficient_planes_from_blocks,
        decode_bytes,
    )
    from jpeg_tpu_torch.ops.fused_plane import decode_planes_fused

    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    plan = parse_jpeg(data)
    coeffs, err = k4.decode_coefficients_device4(plan, device="cpu",
                                                 to_host=False)
    assert not bool(err.any())
    planes = coefficient_planes_from_blocks(coeffs, PipelineGeometry.of(plan))
    rgb = decode_planes_fused(planes, plan, device="cpu")
    np.testing.assert_array_equal(rgb, decode_bytes(data, path="fast",
                                                    device="cpu"))
