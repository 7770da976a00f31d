"""K3 (device entropy) plain version, under the v1 batch name
(``entropy/device_decode.py``), vs jpeg_tpu's windowed Pallas decoder
(interpret mode, one window covering every lane) vs the NumPy oracle: bit
for bit, including error vectors on seeded corrupt streams."""

import numpy as np
import pytest
import torch

from jpeg_tpu.entropy.device_window import decode_coefficients_device5_batch
from jpeg_tpu.entropy.oracle import decode_coefficients
from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu.models.encoder import encode_rgb
from jpeg_tpu_torch.entropy.device_decode import (
    decode_coefficients_device_batch,
)
from jpeg_tpu_torch.entropy.device_huffman import (
    decode_lanes,
    lane_tables,
    prepare_lane_batch,
)
from jpeg_tpu_torch.io.container import plan_from_reference

# Window of the JAX decoder, in 32-bit words: at least every lane's whole
# segment, so it never overflows and the two contracts coincide.
W_CHUNK = 4096


def _plans(seed, n, shape=(64, 80), gray=False, **enc):
    rng = np.random.default_rng(seed)
    refs = []
    for _ in range(n):
        img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        data = encode_rgb(img[..., 0] if gray else img, grayscale=gray, **enc)
        refs.append(ref_parse(data))
    return refs


def _decode_both(refs):
    """-> (port list, port err, jax list, jax err) as numpy."""
    got, err = decode_coefficients_device_batch(
        [plan_from_reference(p) for p in refs], device="cpu")
    want, want_err = decode_coefficients_device5_batch(
        refs, interpret=True, w_chunk=W_CHUNK)
    return ([g.numpy() for g in got], err.numpy(),
            [np.asarray(w) for w in want], np.asarray(want_err))


@pytest.mark.parametrize("sub,gray,ri", [
    ((1, 1), False, 4), ((2, 1), False, 3), ((2, 2), False, 2),
    ((1, 2), False, 3), ((1, 1), True, 6)])
def test_matches_jax_and_oracle(sub, gray, ri):
    refs = _plans(hash((sub, gray)) % 2**31, 2, gray=gray, quality=85,
                  subsampling=sub, restart_interval_mcus=ri)
    got, err, want, want_err = _decode_both(refs)
    assert not err.any() and not want_err.any()
    for g, w, p in zip(got, want, refs):
        assert g.dtype == np.int32 and g.shape == (p.total_blocks, 64)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, decode_coefficients(p))


def test_long_codes_optimized_tables():
    refs = _plans(4, 1, shape=(80, 80), quality=92, subsampling=(2, 2),
                  restart_interval_mcus=5, optimize=True)
    assert max(int(t.lengths.max()) for t in refs[0].ac_tables
               if len(t.lengths)) >= 12  # the canonical walk is exercised
    got, err, want, want_err = _decode_both(refs)
    assert not err.any() and not want_err.any()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], decode_coefficients(refs[0]))


def _lane_rows(plan):
    bpm = plan.blocks_per_mcu
    return [(s.mcu_start * bpm, (s.mcu_start + s.mcu_count) * bpm)
            for s in plan.segments]


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_streams_bit_exact(seed):
    """Seeded byte flips in the scan data: error vectors and every
    coefficient (flagged lanes included) equal the JAX decoder's; unflagged
    lanes equal the oracle, which raises where a lane hits a bad prefix."""
    rng = np.random.default_rng(100 + seed)
    refs = _plans(200 + seed, 3, quality=85, subsampling=(2, 2),
                  restart_interval_mcus=2)
    for p in refs:
        scan = p.scan_data.copy()
        pos = rng.choice(len(scan), size=1 + seed % 3, replace=False)
        scan[pos] ^= rng.integers(1, 256, size=len(pos)).astype(np.uint8)
        p.scan_data = scan
    # 64 one-bits inside a segment are an invalid prefix whatever precedes
    # them (a symbol is at most 31 bits), so at least this lane is flagged.
    s = refs[0].segments[1 + seed % 2]
    mid = (s.byte_start + s.byte_end) // 2
    refs[0].scan_data[mid : mid + 8] = 0xFF
    got, err, want, want_err = _decode_both(refs)
    np.testing.assert_array_equal(err, want_err)
    assert err[1 + seed % 2]
    lane = 0
    for g, w, p in zip(got, want, refs):
        np.testing.assert_array_equal(g, w)
        flags = err[lane : lane + len(p.segments)]
        lane += len(p.segments)
        try:
            ref = decode_coefficients(p)
        except ValueError:
            assert flags.any()
            continue
        for (r0, r1), bad in zip(_lane_rows(p), flags):
            if not bad:
                np.testing.assert_array_equal(g[r0:r1], ref[r0:r1])


def test_truncated_segment_reads_fill_bytes():
    """A lane cut short decodes the 0xAA tail like the TPU kernel and is
    flagged once it runs more than 8 bits past its end."""
    refs = _plans(7, 1, quality=85, subsampling=(1, 1),
                  restart_interval_mcus=4)
    p = refs[0]
    s = p.segments[1]
    s.byte_end = s.byte_start + (s.byte_end - s.byte_start) // 3
    got, err, want, want_err = _decode_both(refs)
    np.testing.assert_array_equal(err, want_err)
    assert err[1] and not err[0]
    np.testing.assert_array_equal(got[0], want[0])


def test_rejects_mixed_tables_before_launch():
    a = _plans(61, 1, quality=85, restart_interval_mcus=4)[0]
    b = _plans(61, 1, quality=85, restart_interval_mcus=4, optimize=True)[0]
    with pytest.raises(ValueError, match="identical slot structure"):
        prepare_lane_batch([plan_from_reference(a), plan_from_reference(b)])


def test_lane_tables_match_jax_tables():
    """The 11-bit LUT and canonical parameters equal the TPU kernel's."""
    from jpeg_tpu.entropy.device_kernel import plan_kernel_tables

    ref = _plans(8, 1, quality=90, subsampling=(2, 2), optimize=True,
                 restart_interval_mcus=3)[0]
    lut, hv, canon = lane_tables(plan_from_reference(ref))
    jl, jh, jc = plan_kernel_tables(ref, "select")
    np.testing.assert_array_equal(lut, jl[:, :, 0])
    np.testing.assert_array_equal(hv, jh[:, :, 0])
    np.testing.assert_array_equal(canon, np.array(
        [sum(map(list, row), []) for row in jc], np.int32))


def test_wrapper_refuses_other_devices():
    batch = prepare_lane_batch([plan_from_reference(
        _plans(9, 1, quality=85, restart_interval_mcus=4)[0])])
    t = {"data": torch.zeros(1, dtype=torch.uint8, device="meta")}
    with pytest.raises(ValueError, match="cpu or cuda"):
        decode_lanes(t, len(batch.lane_start), batch.total_rows)
