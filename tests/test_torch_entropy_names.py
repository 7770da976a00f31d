"""K3 under every device-entropy tier name of jpeg_tpu: the v1 names
(``device_decode``), v2 and v3 (``device_decode2``) and the v5 runner
(``device_window.window_runner_batch``), against the JAX functions on the
CPU (their XLA loops; the v5 chain in interpret mode), on seeded restart
streams, corrupt ones (error vectors and every unflagged lane), a plan with
one segment, and the tables the JAX tiers build (``packed_luts``,
``pair_luts``, ``build_pair_table``), array for array.

One divergence is kept and shown here: a truncated lane reads 0xAA fill in
K3 (and the v5 tier), the next segment's bytes in the v1-v3 loops, so its
flagged garbage differs while the error vectors agree."""

import numpy as np
import pytest
import torch

from jpeg_tpu.entropy import device_decode as ref_v1
from jpeg_tpu.entropy import device_decode2 as ref_v2
from jpeg_tpu.entropy import device_pair as ref_pair
from jpeg_tpu.entropy import device_window as ref_window
from jpeg_tpu.entropy.oracle import decode_coefficients
from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu.models.encoder import encode_rgb
from jpeg_tpu_torch.entropy import device_decode as v1
from jpeg_tpu_torch.entropy import device_decode2 as v2
from jpeg_tpu_torch.entropy import device_huffman, device_pair, device_window
from jpeg_tpu_torch.io.container import plan_from_reference

CPU = "cpu"


# Scan bytes are padded with 0xAA, the fill every tier reads past a lane's
# end, to a whole number of these: the JAX loops then see one input shape
# per geometry and compile once for all the streams of a test.
PAD = 8192


def _refs(seed, n, shape=(48, 64), gray=False, **enc):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        p = ref_parse(encode_rgb(img[..., 0] if gray else img,
                                 grayscale=gray, **enc))
        fill = np.full(-len(p.scan_data) % PAD, 0xAA, np.uint8)
        p.scan_data = np.concatenate([np.asarray(p.scan_data, np.uint8), fill])
        out.append(p)
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _singles(ref):
    """(name, port (coeffs, err), JAX (coeffs, err)) of every one-plan name."""
    plan = plan_from_reference(ref)
    return [
        ("v1", v1.decode_coefficients_device(plan, device=CPU),
         ref_v1.decode_coefficients_device(ref)),
        ("v2", v2.decode_coefficients_device2(plan, device=CPU),
         ref_v2.decode_coefficients_device2(ref)),
        ("v3", v2.decode_coefficients_device3(plan, device=CPU),
         ref_v2.decode_coefficients_device3(ref)),
    ]


def _batches(refs):
    plans = [plan_from_reference(r) for r in refs]
    return [
        ("v1 batch", v1.decode_coefficients_device_batch(plans, device=CPU),
         ref_v1.decode_coefficients_device_batch(refs)),
        ("v2 batch", v2.decode_coefficients_device2_batch(plans, device=CPU),
         ref_v2.decode_coefficients_device2_batch(refs)),
    ]


def _assert_equal(name, got, want, refs):
    """Error vectors equal; every coefficient of every unflagged lane equal
    (a flagged lane's garbage may differ where it ran past its segment end:
    see :func:`test_truncated_lane_diverges_only_in_flagged_garbage`)."""
    (gc, ge), (wc, we) = got, want
    ge = _np(ge)
    np.testing.assert_array_equal(ge, _np(we), err_msg=name)
    if not isinstance(gc, list):
        gc, wc = [gc], [wc]
    assert len(gc) == len(wc) == len(refs)
    lane = 0
    for g, w, ref in zip(gc, wc, refs):
        assert g.dtype == torch.int32
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        bpm = ref.blocks_per_mcu
        for seg in ref.segments:
            r0, r1 = seg.mcu_start * bpm, (seg.mcu_start + seg.mcu_count) * bpm
            if not ge[lane]:
                np.testing.assert_array_equal(g[r0:r1], w[r0:r1], err_msg=name)
            lane += 1


@pytest.mark.parametrize("sub,gray,ri", [
    ((1, 1), False, 1), ((2, 1), False, 2), ((2, 2), False, 2),
    ((1, 2), False, 2), ((1, 1), True, 2)])
def test_names_match_jax_on_restart_streams(sub, gray, ri):
    refs = _refs(hash((sub, gray, ri)) % 2**31, 2, gray=gray, quality=85,
                 subsampling=sub, restart_interval_mcus=ri)
    for name, got, want in _singles(refs[0]):
        _assert_equal(name, got, want, refs[:1])
        assert not _np(got[1]).any()
    for name, got, want in _batches(refs):
        _assert_equal(name, got, want, refs)
        assert not _np(got[1]).any()
    got = v1.decode_coefficients_device(plan_from_reference(refs[1]),
                                        device=CPU)[0]
    np.testing.assert_array_equal(got.numpy(), decode_coefficients(refs[1]))


def _corrupt(seed):
    rng = np.random.default_rng(100 + seed)
    refs = _refs(200 + seed, 3, quality=85, subsampling=(2, 2),
                 restart_interval_mcus=2)
    for p in refs:
        scan = p.scan_data.copy()
        pos = rng.choice(len(scan), size=1 + seed % 3, replace=False)
        scan[pos] ^= rng.integers(1, 256, size=len(pos)).astype(np.uint8)
        p.scan_data = scan
    s = refs[0].segments[1 + seed % 2]
    mid = (s.byte_start + s.byte_end) // 2
    refs[0].scan_data[mid : mid + 8] = 0xFF  # an invalid prefix mid-lane
    return refs


@pytest.mark.parametrize("seed", range(3))
def test_names_match_jax_on_corrupt_streams(seed):
    """Byte flips: the error vectors and every unflagged lane equal the JAX
    functions'; the lane with an invalid prefix is flagged."""
    refs = _corrupt(seed)
    for name, got, want in _singles(refs[0]):
        _assert_equal(name, got, want, refs[:1])
    for name, got, want in _batches(refs):
        _assert_equal(name, got, want, refs)
        assert _np(got[1])[1 + seed % 2]


def test_single_segment_plan_is_one_lane():
    """A plan without restart markers is one lane (``S = 1``) for every
    name, equal to the JAX functions and the oracle."""
    ref = _refs(31, 1, shape=(32, 40), quality=85, subsampling=(2, 2))[0]
    assert len(ref.segments) == 1
    batch = device_huffman.prepare_lane_batch([plan_from_reference(ref)])
    assert len(batch.lane_start) == 1
    for name, got, want in _singles(ref):
        _assert_equal(name, got, want, [ref])
        assert got[1].shape == (1,) and not got[1].any()
        np.testing.assert_array_equal(got[0].numpy(), decode_coefficients(ref))


def test_truncated_lane_diverges_only_in_flagged_garbage():
    """A lane cut short: K3 reads 0xAA past its end (the v5 contract), the
    v1-v3 loops read the next segment's bytes. The error vectors agree and
    every unflagged lane is equal; the flagged lane's garbage differs."""
    ref = _refs(7, 1, quality=85, subsampling=(1, 1),
                restart_interval_mcus=4)[0]
    s = ref.segments[1]
    s.byte_end = s.byte_start + (s.byte_end - s.byte_start) // 3
    bpm = ref.blocks_per_mcu
    rows = [(g.mcu_start * bpm, (g.mcu_start + g.mcu_count) * bpm)
            for g in ref.segments]
    for name, (gc, ge), (wc, we) in _singles(ref):
        ge, we, gc, wc = _np(ge), _np(we), _np(gc), _np(wc)
        np.testing.assert_array_equal(ge, we, err_msg=name)
        assert ge[1] and ge.sum() == 1
        for (r0, r1), bad in zip(rows, ge):
            if bad:
                assert not np.array_equal(gc[r0:r1], wc[r0:r1]), name
            else:
                np.testing.assert_array_equal(gc[r0:r1], wc[r0:r1])


def test_window_runner_batch_matches_jax():
    """``run(*args)`` launches K3 on the prepared lanes; each lane's rows
    equal the JAX chain's, and ``meta`` carries its ``max_mcus, S,
    lane_base, bitend``."""
    refs = _corrupt(1)[:2] + _refs(9, 1, quality=85, subsampling=(2, 2),
                                   restart_interval_mcus=3)
    plans = [plan_from_reference(r) for r in refs]
    before = device_huffman.LAUNCHES.value
    run, args, meta = device_window.window_runner_batch(plans, device=CPU)
    coeffs, err = run(*args)
    assert device_huffman.LAUNCHES.value == before  # the plain version
    jrun, jargs, jmeta = ref_window.window_runner_batch(refs, interpret=True,
                                                        w_chunk=4096)
    out, state = jrun(*jargs)
    max_mcus, S, lane_base, bitend = meta
    assert (max_mcus, S, lane_base) == tuple(jmeta[:3])
    np.testing.assert_array_equal(bitend.numpy(), np.asarray(jmeta[3]))
    jerr, _bits = ref_window._final_err(state, jmeta[3])
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    bpm = refs[0].blocks_per_mcu
    flat = np.moveaxis(np.asarray(out)[:max_mcus], 3, 0).reshape(
        S, max_mcus * bpm, 64)
    lanes = [s for r in refs for s in r.segments]
    starts = args[0]["lane_out"].numpy()
    for lane, (seg, r0) in enumerate(zip(lanes, starts)):
        n = seg.mcu_count * bpm
        np.testing.assert_array_equal(coeffs.numpy()[r0:r0 + n],
                                      flat[lane, :n])


def test_tables_match_jax():
    ref = _refs(8, 1, quality=90, subsampling=(2, 2), optimize=True,
                restart_interval_mcus=3)[0]
    plan = plan_from_reference(ref)
    np.testing.assert_array_equal(v1.packed_luts(plan), ref_v1.packed_luts(ref))
    got, got_slots = device_pair.pair_luts(plan)
    want, want_slots = ref_pair.pair_luts(ref)
    assert got.dtype == want.dtype and got_slots == want_slots
    np.testing.assert_array_equal(got, want)
    for first, follow, dc in [(plan.dc_tables[0], plan.ac_tables[0], True),
                              (plan.ac_tables[1], plan.ac_tables[1], False),
                              (plan.dc_tables[1], plan.ac_tables[1], True)]:
        rf = ref.dc_tables[0] if first is plan.dc_tables[0] else (
            ref.dc_tables[1] if dc else ref.ac_tables[1])
        np.testing.assert_array_equal(
            device_pair.build_pair_table(first, follow, dc),
            ref_pair.build_pair_table(rf, ref.ac_tables[
                0 if first is plan.dc_tables[0] else 1], dc))


def test_luts_accepted_only_as_the_plan_derives_them():
    """K3 builds its own tables: ``luts`` equal to the JAX tables decode as
    without them; other tables raise ``ValueError`` before any launch, where
    the JAX loops decode with them (zeroed tables flag every lane)."""
    ref = _refs(3, 1, shape=(16, 16), quality=80, subsampling=(1, 1),
                restart_interval_mcus=1)[0]
    plan = plan_from_reference(ref)
    base = v1.decode_coefficients_device(plan, device=CPU)
    for got in (v1.decode_coefficients_device(
                    plan, luts=v1.packed_luts(plan), device=CPU),
                v2.decode_coefficients_device2(
                    plan, luts=torch.from_numpy(v1.packed_luts(plan)),
                    device=CPU),
                v2.decode_coefficients_device3(
                    plan, luts=device_pair.pair_luts(plan)[0], device=CPU)):
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    zero = np.zeros_like(v1.packed_luts(plan))
    _, jerr = ref_v1.decode_coefficients_device(ref, luts=zero)
    assert np.asarray(jerr).all()
    before = device_huffman.LAUNCHES.value
    for call in (lambda: v1.decode_coefficients_device(plan, luts=zero),
                 lambda: v1.decode_coefficients_device_batch([plan], zero),
                 lambda: v2.decode_coefficients_device2(plan, luts=zero),
                 lambda: v2.decode_coefficients_device3(
                     plan, luts=v1.packed_luts(plan))):
        with pytest.raises(ValueError, match="luts must equal"):
            call()
    assert device_huffman.LAUNCHES.value == before


def test_batch_refusals_and_gate():
    a = _refs(61, 1, quality=85, restart_interval_mcus=4)[0]
    b = _refs(61, 1, quality=85, restart_interval_mcus=4, optimize=True)[0]
    mixed = [plan_from_reference(a), plan_from_reference(b)]
    for fn in (v1.decode_coefficients_device_batch,
               v2.decode_coefficients_device2_batch,
               device_window.window_runner_batch):
        with pytest.raises(ValueError, match="identical slot structure"):
            fn(mixed, device=CPU)
        with pytest.raises(ValueError, match="empty batch"):
            fn([], device=CPU)
    for ref_fn in (ref_v1.decode_coefficients_device_batch,
                   ref_v2.decode_coefficients_device2_batch):
        with pytest.raises(ValueError, match="identical"):
            ref_fn([a, b])
    for n in (None, 2, 5, 9):
        assert v1.device_path_profitable(mixed[0], n) == \
            ref_v1.device_path_profitable(a, n)
