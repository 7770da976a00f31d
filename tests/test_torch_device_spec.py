"""K7's module, ``jpeg_tpu_torch/entropy/device_spec.py``, against
``jpeg_tpu/entropy/device_spec.py`` on the CPU: every case of
``tests/test_device_spec.py`` and ``test_12bit.py::test_spec_chunk_lanes_12bit``
through both packages on the same streams (the JAX package's encoder on
seeded NumPy images), coefficients bit for bit and the same ``stats``; phase
A itself (K7's plain twin) against the JAX ``_compiled_spec_kernel`` at
every index the host merge reads; corrupt streams; ``luts`` refused before
anything is launched. K7 against its twin on the card is in
``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_tpu.entropy import device_spec as ref
from jpeg_tpu.entropy.device_decode import packed_luts as ref_packed_luts
from jpeg_tpu.entropy.device_decode2 import (
    _plan_pair_ids,
    _plan_slot_ids,
    _scan_words,
    _scan_words2,
)
from jpeg_tpu.entropy.device_pair import pair_luts as ref_pair_luts
from jpeg_tpu.entropy.oracle import decode_coefficients
from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu.models.encoder import encode_rgb
from jpeg_tpu_torch.entropy import device_spec as spec
from jpeg_tpu_torch.entropy.device_decode import packed_luts
from jpeg_tpu_torch.entropy.device_pair import pair_luts
from jpeg_tpu_torch.io.container import parse_jpeg


def _noise(shape, seed, high=256, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, high, shape, dtype=dtype)


def _noise12(shape, seed):
    """tests/test_12bit.py's 12-bit noise."""
    return _noise(shape, seed, 4096, np.uint16)


def _both(data, lanes, overlap, pair=False):
    """Both packages' decode of ``data``: the same coefficients (or both
    None) and the same stats. Returns (port coefficients, stats)."""
    want, want_stats = ref.decode_coefficients_device_spec(
        ref_parse(data), target_lanes=lanes, overlap_mcus=overlap, pair=pair)
    got, stats = spec.decode_coefficients_device_spec(
        parse_jpeg(data), target_lanes=lanes, overlap_mcus=overlap, pair=pair,
        device="cpu")
    assert stats == want_stats
    assert (got is None) == (want is None)
    if got is not None:
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got, stats


def _roundtrip(img, lanes, overlap, pair=False, **enc):
    data = encode_rgb(img, quality=enc.pop("quality", 80), **enc)
    got, stats = _both(data, lanes, overlap, pair)
    assert got is not None, stats
    np.testing.assert_array_equal(got.numpy(),
                                  decode_coefficients(ref_parse(data)))
    return stats


@pytest.mark.parametrize(
    "sub,size,lanes",
    [
        ((1, 1), (128, 128), 16),
        ((2, 1), (192, 256), 24),
        ((2, 2), (256, 256), 32),
        ((1, 2), (160, 160), 16),
    ],
)
def test_matches_jax_no_restarts(sub, size, lanes):
    _roundtrip(_noise(size + (3,), hash((sub, size)) % 2**31), lanes, 24,
               subsampling=sub)


def test_gap_recovery_forced_by_tiny_overlap():
    stats = _roundtrip(_noise((256, 256, 3), 11), 48, 2, subsampling=(2, 2))
    assert stats["gap_mcus"] > 0


def test_restart_segments_with_gap_recovery():
    stats = _roundtrip(_noise((256, 320, 3), 12), 64, 4, subsampling=(2, 2),
                       restart_interval_mcus=20)
    assert stats["merged"] > 1


def test_grayscale_heavy_gaps():
    stats = _roundtrip(_noise((200, 200), 13), 32, 3)
    assert stats["gap_mcus"] > 0


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_stream_matches_jax(seed):
    """A flipped byte: the same outcome as the JAX function, None or the
    same array, and an array only where it is the oracle's garbage."""
    data = bytearray(encode_rgb(_noise((128, 128, 3), seed), quality=80,
                                subsampling=(1, 1)))
    data[len(data) // 2 + seed] ^= 0xFF
    got, _stats = _both(bytes(data), 16, 4)
    if got is not None:
        np.testing.assert_array_equal(
            got.numpy(), decode_coefficients(ref_parse(bytes(data))))


def _big_magnitude_stream():
    """tests/test_device_spec.py's 12-bit stream with >= 13-bit values."""
    img = _noise((96, 96, 3), 31, 4096, np.uint16)
    yy, xx = np.mgrid[0:96, 0:96]
    flat = np.where(((yy // 8 + xx // 8) % 2) == 0, 0, 4095)
    checker = np.where(((yy + xx) % 2) == 0, 0, 4095)
    img[..., 0] = np.where(((yy // 8) % 2) == 0, flat, checker)
    return encode_rgb(img, quality=100, subsampling=(1, 1), precision=12,
                      engine="python", optimize=True)


def test_pair_kernel_12bit_large_magnitudes():
    data = _big_magnitude_stream()
    assert int(np.abs(decode_coefficients(ref_parse(data))).max()) >= 4096
    got, stats = _both(data, 16, 8, pair=True)
    assert got is not None, stats
    np.testing.assert_array_equal(got.numpy(),
                                  decode_coefficients(ref_parse(data)))


def test_pair_kernel_spec_path():
    _roundtrip(_noise((160, 192, 3), 21), 24, 8, pair=True,
               subsampling=(2, 2))


def test_spec_chunk_lanes_12bit():
    data = encode_rgb(_noise12((96, 112, 3), 31), quality=96,
                      subsampling=(1, 1), precision=12, engine="python")
    got, stats = _both(data, 16, 6)
    assert got is not None, stats
    np.testing.assert_array_equal(got.numpy(),
                                  decode_coefficients(ref_parse(data)))


PHASE_A = {
    "420-overlap8": (lambda: encode_rgb(_noise((160, 192, 3), 21), quality=80,
                                        subsampling=(2, 2)), 24, 8),
    "420-overlap2": (lambda: encode_rgb(_noise((256, 256, 3), 11), quality=80,
                                        subsampling=(2, 2)), 48, 2),
    "restarts": (lambda: encode_rgb(_noise((256, 320, 3), 12), quality=80,
                                    subsampling=(2, 2),
                                    restart_interval_mcus=20), 64, 4),
    "gray": (lambda: encode_rgb(_noise((200, 200), 13), quality=80), 32, 3),
    "12bit-large": (_big_magnitude_stream, 16, 8),
}


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("case", PHASE_A)
def test_phase_a_matches_jax_kernel(case, pair):
    """The plain twin (K7's contract) against ``_compiled_spec_kernel`` on
    the same lanes (the JAX kernel's single-symbol form, and its pair form,
    which K7 also answers): ``n_dec`` equal; per lane ``mcu_bits`` and
    ``dc_cum`` at 0..n_dec (what the merge reads; past it the JAX loop
    keeps writing a dead lane's last cursor) and every ``out`` row equal."""
    make, lanes, overlap = PHASE_A[case]
    data = make()
    r, p = ref_parse(data), parse_jpeg(data)
    ls, ce, se, groups = spec._chunk_lanes(p, lanes)
    ref_ls, ref_ce, ref_se, ref_groups = ref._chunk_lanes(r, lanes)
    for a, b in ((ls, ref_ls), (ce, ref_ce), (se, ref_se)):
        np.testing.assert_array_equal(a, b)
    assert [(f, k) for _s, f, k in groups] == [(f, k) for _s, f, k in ref_groups]
    cap = spec.spec_cap(groups, overlap)
    ids = (_plan_pair_ids if pair else _plan_slot_ids)(r)
    kernel = ref._compiled_spec_kernel(len(r.components), cap, *ids, overlap,
                                       pair)
    words = (_scan_words2 if pair else _scan_words)(r.scan_data)
    luts = ref_pair_luts(r)[0] if pair else ref_packed_luts(r)
    want = [np.asarray(x) for x in kernel(
        jnp.asarray(words), jnp.asarray(luts), jnp.asarray(ls),
        jnp.asarray(ce), jnp.asarray(se))]
    t = spec.spec_tensors(p, ls, ce, se, "cpu")
    got = [x.numpy() for x in spec.spec_lanes(
        t, len(p.scan_data), cap, overlap, len(p.components))]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.int32
    out, mcu_bits, dc_cum, n_dec = got
    np.testing.assert_array_equal(n_dec, want[3])
    np.testing.assert_array_equal(out, want[0])
    for lane, nd in enumerate(n_dec):
        np.testing.assert_array_equal(mcu_bits[lane, : nd + 1],
                                      want[1][lane, : nd + 1])
        np.testing.assert_array_equal(dc_cum[lane, : nd + 1],
                                      want[2][lane, : nd + 1])
    assert (n_dec < cap).any()  # some lane stopped before its budget


def test_control_arrays_come_back_in_one_copy():
    """``control_to_host`` splits one flat copy back into the three
    arrays, and the merge of those equals the decode's own result."""
    data = encode_rgb(_noise((128, 128, 3), 3), quality=80, subsampling=(2, 2))
    p = parse_jpeg(data)
    ls, ce, se, groups = spec._chunk_lanes(p, 16)
    cap = spec.spec_cap(groups, 4)
    t = spec.spec_tensors(p, ls, ce, se, "cpu")
    out, *ctrl = spec.spec_lanes(t, len(p.scan_data), cap, 4, 3)
    host = spec.control_to_host(*ctrl)
    for h, c in zip(host, ctrl):
        assert h.shape == tuple(c.shape)
        np.testing.assert_array_equal(h, c.numpy())
    stats = {"merged": 0, "failed": 0, "gap_mcus": 0}
    merged = spec.merge_lanes(p, groups, *host, cap, stats)
    want, want_stats = spec.decode_coefficients_device_spec(
        p, 16, 4, device="cpu")
    assert torch.equal(spec.relocate(p, out, *merged), want)
    assert stats == {k: want_stats[k] for k in stats}


@pytest.mark.parametrize("pair", [False, True])
def test_luts_refused_before_launch(pair, monkeypatch):
    """``luts`` other than the tables the JAX function would build raise
    ``ValueError`` before phase A runs; the right ones are accepted."""
    data = encode_rgb(_noise((64, 64, 3), 5), quality=80)
    p = parse_jpeg(data)
    right = pair_luts(p)[0] if pair else packed_luts(p)
    calls = []
    real = spec.spec_lanes
    monkeypatch.setattr(spec, "spec_lanes",
                        lambda *a: calls.append(1) or real(*a))
    with pytest.raises(ValueError, match="luts"):
        spec.decode_coefficients_device_spec(p, 8, 4, luts=right + 1,
                                             pair=pair, device="cpu")
    with pytest.raises(ValueError, match="luts"):
        spec.decode_coefficients_device_spec(p, 8, 4, luts=right[:1],
                                             pair=pair, device="cpu")
    assert calls == []
    got, _ = spec.decode_coefficients_device_spec(
        p, 8, 4, luts=torch.from_numpy(right), pair=pair, device="cpu")
    assert calls == [1]
    np.testing.assert_array_equal(got.numpy(), decode_coefficients(ref_parse(data)))


def test_device_other_than_cpu_or_cuda_raises():
    p = parse_jpeg(encode_rgb(_noise((32, 32, 3), 6), quality=80))
    ls, ce, se, groups = spec._chunk_lanes(p, 4)
    t = spec.spec_tensors(p, ls, ce, se, "meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        spec.spec_lanes(t, len(p.scan_data), spec.spec_cap(groups, 4), 4, 3)


KERNEL_TABLES = {"skip", "skip_hv", "skip_canon", "skip_slots"}
PLAIN_TABLES = {"lut11", "huffval", "canon", "slots"}


@pytest.mark.parametrize("device,tables,want", [
    ("cpu", None, PLAIN_TABLES), ("cpu", "plain", PLAIN_TABLES),
    ("cpu", "kernel", KERNEL_TABLES), ("cpu", "both", KERNEL_TABLES | PLAIN_TABLES),
    ("meta", None, PLAIN_TABLES)])
def test_spec_tensors_carry_the_tables_of_the_side_that_reads_them(
        device, tables, want):
    """Only the tables its reader needs go to the device: K7's by default
    on CUDA (not testable here), the plain version's elsewhere, both for a
    comparison; the kernel's equal K3's ``kernel_tables``."""
    from jpeg_tpu_torch.entropy import device_huffman

    p = parse_jpeg(encode_rgb(_noise((32, 48, 3), 7), quality=80))
    ls, ce, se, _groups = spec._chunk_lanes(p, 4)
    t = spec.spec_tensors(p, ls, ce, se, device, tables=tables)
    lanes = {"data", "bit_start", "chunk_end_bit", "seg_end_bit"}
    assert set(t) == lanes | want
    assert all(x.device.type == device for x in t.values())
    if device == "cpu" and "skip" in t:
        lut, hv, canon = device_huffman.lane_tables(p)
        skip, _pair, skip_hv, skip_canon, skip_slots = (
            device_huffman.kernel_tables(lut, hv, canon,
                                         device_huffman.slot_rows(p)))
        for k, v in (("skip", skip), ("skip_hv", skip_hv),
                     ("skip_canon", skip_canon), ("skip_slots", skip_slots)):
            np.testing.assert_array_equal(t[k].numpy(), v)
    with pytest.raises(ValueError, match="tables"):
        spec.spec_tensors(p, ls, ce, se, device, tables="twin")


def test_sync_is_looked_for_only_up_to_the_segment_end():
    """A valid restart stream on which the JAX merge fails a segment: past
    the segment's last MCU, two lanes that decode the padding and the next
    segment's bytes meet at one position by chance, the JAX merge takes it
    as their sync point, finds more MCUs than the segment holds and calls
    the segment corrupt. The port looks for sync points only up to the
    segment's end and decodes the stream bit for bit; every other segment
    merges as in the JAX package."""
    rng = np.random.default_rng(155)
    yy, xx = np.mgrid[0:108, 0:128].astype(np.float32)
    img = np.stack([128 + 80 * np.sin(xx / 9.0 + 155) * np.cos(yy / 7.0),
                    128 + 80 * np.sin(xx / 5.0 + 1) * np.cos(yy / 11.0 + 155),
                    128 + 60 * np.cos(xx / 13.0)], -1)
    img = np.clip(img + rng.normal(0, 25, img.shape), 0, 255).astype(np.uint8)
    data = encode_rgb(img, quality=79, subsampling=(2, 2),
                      restart_interval_mcus=11)
    r, p = ref_parse(data), parse_jpeg(data)
    want, want_stats = ref.decode_coefficients_device_spec(
        r, target_lanes=82, overlap_mcus=6)
    got, stats = spec.decode_coefficients_device_spec(
        p, target_lanes=82, overlap_mcus=6, device="cpu")
    assert want is None and want_stats["failed"] == 1
    assert got is not None
    assert stats["merged"] == len(p.segments) > want_stats["merged"]
    assert stats["failed"] == 0
    np.testing.assert_array_equal(got.numpy(), decode_coefficients(r))
    # The failing segment's two lanes: past its end they share a position.
    ls, ce, se, groups = spec._chunk_lanes(p, 82)
    cap = spec.spec_cap(groups, 6)
    _out, mcu_bits, _dc, n_dec = (x.numpy() for x in spec.spec_lanes(
        spec.spec_tensors(p, ls, ce, se, "cpu"), len(p.scan_data), cap, 6, 3))
    s, first, _k = groups[want_stats["merged"]]
    shared = [
        set(mcu_bits[lane, : n_dec[lane] + 1])
        & set(mcu_bits[lane + 1, : n_dec[lane + 1] + 1])
        for lane in range(first, first + _k - 1)]
    assert any(pos > s.byte_end * 8 for common in shared for pos in common)
