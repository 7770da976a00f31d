"""The rest of the format matrix in jpeg_tpu_torch against jpeg_tpu: 12-bit
decode (SOF1, SOF9, SOF2, SOF10) through every entry point that reaches the
compat route, and the encoders that write those streams, byte for byte:
``encode_rgb(precision=12)``, ``encode_rgb(arithmetic=True)``,
``encode_rgb_progressive`` (Huffman and arithmetic, 8 and 12 bits),
``encode_cmyk(arithmetic=True)``, the C++ bindings under them, the copied
progressive scan encoder, and the 16-bit PPM reader.

Bars: encoded bytes equal; 12-bit samples ``uint16`` and within +-1 of the
JAX package's (the +-1 the 8-bit compat route holds), with under 5% of the
values differing.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu import runtime as ref_rt
from jpeg_tpu.entropy import progressive_encode as ref_pe
from jpeg_tpu.io import ppm as ref_ppm
from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu.io.corpus import synthetic_image
from jpeg_tpu.models import encoder as ref_enc
from jpeg_tpu.parallel import batch as ref_batch
from jpeg_tpu_torch import (
    BatchedCorpusDecoder,
    CorpusDecoder,
    decode_batch,
    decode_bytes,
    decode_file,
    runtime,
)
from jpeg_tpu_torch.entropy import progressive_encode as pe
from jpeg_tpu_torch.entropy import lossless
from jpeg_tpu_torch.io import ppm
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.models import decoder as dec
from jpeg_tpu_torch.models import encoder as enc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLINGS = ["gray", (1, 1), (2, 1), (2, 2), (1, 2)]


def _image(seed, precision=12, size=(48, 64), gray=False):
    img = synthetic_image(size[1], size[0], seed=seed)
    if gray:
        img = img[..., 0]
    if precision == 12:
        # Use the low bits too, so 12-bit magnitudes reach their categories.
        rng = np.random.default_rng(seed)
        img = (img.astype(np.uint16) << 4) | rng.integers(
            0, 16, img.shape).astype(np.uint16)
    return img


def _encode(module, kind, sampling, precision, **kw):
    gray = sampling == "gray"
    img = _image(hash((kind, str(sampling))) % 1000, precision, gray=gray)
    sub = (1, 1) if gray else sampling
    if kind in ("sof2", "sof10"):
        return module.encode_rgb_progressive(
            img, quality=88, subsampling=sub, precision=precision,
            arithmetic=kind == "sof10", **kw)
    return module.encode_rgb(img, quality=88, subsampling=sub,
                             precision=precision, arithmetic=kind == "sof9",
                             **kw)


def _within_one(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05


SOF_MARKER = {("sof1", 12): 0xC1, ("sof9", 12): 0xC9, ("sof2", 12): 0xC2,
              ("sof10", 12): 0xCA, ("sof9", 8): 0xC9, ("sof2", 8): 0xC2,
              ("sof10", 8): 0xCA}


@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("kind", ["sof1", "sof9", "sof2", "sof10"])
def test_twelve_bit_encode_and_decode_match_jax(kind, sampling):
    data = _encode(enc, kind, sampling, 12)
    assert data == _encode(ref_enc, kind, sampling, 12)
    assert bytes([0xFF, SOF_MARKER[(kind, 12)]]) in data
    plan = parse_jpeg(data)
    assert plan.precision == 12
    for path in ("compat", "fast"):
        got = decode_bytes(data, path=path, device="cpu")
        assert got.dtype == np.uint16 and got.max() > 255
        _within_one(got, np.asarray(jpeg_tpu.decode_bytes(data, path=path)))


@pytest.mark.parametrize("sampling", ["gray", (2, 2)])
@pytest.mark.parametrize("kind", ["sof9", "sof2", "sof10"])
def test_eight_bit_encoders_match_jax(kind, sampling):
    data = _encode(enc, kind, sampling, 8)
    assert data == _encode(ref_enc, kind, sampling, 8)
    assert bytes([0xFF, SOF_MARKER[(kind, 8)]]) in data
    got = decode_bytes(data, device="cpu")
    assert got.dtype == np.uint8
    _within_one(got, np.asarray(jpeg_tpu.decode_bytes(data)))


@pytest.mark.parametrize("kind,kw", [
    ("sof1", dict(restart_interval_mcus=3, comment="twelve")),
    ("sof9", dict(restart_interval_mcus=2)),
    ("sof9", dict(restart_interval_mcus=5, engine="python")),
    ("sof2", dict(restart_interval=4)),
    ("sof10", dict(restart_interval=3)),
])
def test_restart_intervals_and_options_match_jax(kind, kw):
    data = _encode(enc, kind, (2, 2), 12, **kw)
    assert data == _encode(ref_enc, kind, (2, 2), 12, **kw)
    assert parse_jpeg(data).restart_interval
    _within_one(decode_bytes(data, device="cpu"),
                np.asarray(jpeg_tpu.decode_bytes(data)))


def test_encoders_round_trip_their_own_coefficients():
    """The port decodes each new encoder's stream back to the quantized
    coefficients the encoder coded (all three codings share the forward
    transform): the round trip the card repeats without JAX or PIL."""
    img = _image(3)
    blocks = enc._forward_transform(img, 88, (2, 1), False, 12)[0]
    streams = [enc.encode_rgb(img, quality=88, subsampling=(2, 1),
                              precision=12, arithmetic=a) for a in (0, 1)]
    streams += [enc.encode_rgb_progressive(img, quality=88, subsampling=(2, 1),
                                           precision=12, arithmetic=a)
                for a in (0, 1)]
    for data in streams:
        plan = parse_jpeg(data)
        coeffs = dec.decode_coefficients_host(plan)
        geom = dec.PipelineGeometry.of(plan)
        for (off, k), (h, v), want in zip(geom.component_slot_ranges(),
                                          geom.sampling, blocks):
            got = coeffs.reshape(geom.n_mcus, geom.blocks_per_mcu, 64)[
                :, off:off + k].reshape(geom.mcus_y, geom.mcus_x, v, h, 64)
            got = got.transpose(0, 2, 1, 3, 4).reshape(want.shape)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ycck", [False, True])
def test_arithmetic_cmyk_matches_jax(ycck):
    cmyk = np.random.default_rng(4).integers(0, 256, (24, 40, 4), np.uint8)
    for engine in ("native", "python"):
        data = enc.encode_cmyk(cmyk, ycck=ycck, arithmetic=True, engine=engine,
                               restart_interval_mcus=3)
        assert data == ref_enc.encode_cmyk(cmyk, ycck=ycck, arithmetic=True,
                                           restart_interval_mcus=3)
    _within_one(decode_bytes(data, device="cpu"),
                np.asarray(jpeg_tpu.decode_bytes(data)))


@pytest.mark.parametrize("restart", [0, 1, 4])
def test_native_encoders_match_jax_bindings(restart):
    """``native_encode_arith_scan`` and ``native_encode_progressive_scans``
    equal the JAX bindings, and the C++ progressive scans equal the copied
    Python encoder."""
    img = _image(8)
    blocks, samplings, _q, h, w, mx, my, _g = enc._forward_transform(
        img, 80, (2, 2), False, 12)
    planes = enc._natural_planes(blocks)
    slots = enc._slots(samplings)
    hs, vs = [s[0] for s in samplings], [s[1] for s in samplings]
    args = (planes, slots, hs, vs, mx, mx * my, restart, [0, 1, 1])
    assert runtime.native_encode_arith_scan(*args) == \
        ref_rt.native_encode_arith_scan(*args)
    got = runtime.native_encode_progressive_scans(
        blocks, samplings, mx, my, w, h, restart_interval=restart)
    want = ref_rt.native_encode_progressive_scans(
        blocks, samplings, mx, my, w, h, restart_interval=restart)
    python = pe.encode_progressive_scans(blocks, samplings, mx, my, w, h,
                                         restart_interval=restart)
    assert len(got) == len(want) == len(python)
    for g, r, p in zip(got, want, python):
        for key in ("comps", "ss", "se", "ah", "al", "data"):
            assert g[key] == r[key] == p[key], key
        for (gc, gs, gt), (rc, rs, rt) in zip(g["tables"], r["tables"]):
            assert (gc, gs) == (rc, rs)
            np.testing.assert_array_equal(gt.bits, rt.bits)
            np.testing.assert_array_equal(gt.values, rt.values)


def test_progressive_scan_script_copy():
    for ncomp in (1, 3, 4):
        assert pe.standard_scan_script(ncomp) == ref_pe.standard_scan_script(
            ncomp)
    with pytest.raises(ValueError, match="refinement"):
        runtime.native_encode_progressive_scans(
            [np.zeros((1, 1, 64), np.int32)], [(1, 1)], 1, 1, 8, 8,
            scan_script=[((0,), 0, 0, 2, 0)])


@pytest.mark.parametrize("upsample,color_space", [
    ("fancy", "rgb"), ("replicate", "ycbcr"), ("fancy", "ycbcr")])
def test_twelve_bit_compat_options_match_jax(upsample, color_space):
    """Fancy upsampling takes no ``maxval`` in either package: 12-bit planes
    go through it unchanged; ``color_space="ycbcr"`` keeps u16 planes."""
    for sampling in ("gray", (2, 2), (2, 1)):
        data = _encode(ref_enc, "sof1", sampling, 12)
        got = decode_bytes(data, upsample=upsample, color_space=color_space,
                           device="cpu")
        want = np.asarray(jpeg_tpu.decode_bytes(
            data, upsample=upsample, color_space=color_space))
        assert got.dtype == np.uint16
        _within_one(got, want)
        if color_space == "ycbcr" and sampling == "gray":
            assert (got[..., 1:] == 2048).all()


def test_decode_batch_and_file_on_twelve_bit(tmp_path):
    """``decode_batch`` carries the geometry's precision into the compat
    pipeline, as the JAX ``_batched_pipeline`` does; ``decode_file`` takes
    the compat route."""
    streams = [_encode(ref_enc, "sof1", (2, 2), 12) for _ in range(1)]
    streams.append(ref_enc.encode_rgb(_image(77), quality=70,
                                      subsampling=(2, 2), precision=12))
    plans = [parse_jpeg(d) for d in streams]
    geom = dec.PipelineGeometry.of(plans[0])
    assert geom.precision == 12 and geom == dec.PipelineGeometry.of(plans[1])
    coeffs = np.stack([dec.decode_coefficients_host(p).copy() for p in plans])
    mats = np.stack([dec.plan_matrices(p) for p in plans])
    got = decode_batch(coeffs, mats, geom, device="cpu").numpy()
    from jpeg_tpu.models.decoder import PipelineGeometry as RefGeometry

    want = np.asarray(ref_batch.decode_batch(
        coeffs, mats, RefGeometry.of(ref_parse(streams[0]))))
    assert got.dtype == np.uint16
    _within_one(got, want)
    for g, d in zip(got, streams):
        np.testing.assert_array_equal(g, decode_bytes(d, device="cpu"))
    path = tmp_path / "twelve.jpg"
    path.write_bytes(streams[1])
    np.testing.assert_array_equal(decode_file(str(path), device="cpu"),
                                  decode_bytes(streams[1], device="cpu"))


def test_corpus_decoders_decode_twelve_bit_and_lossless_inline():
    """Both corpus decoders route 12-bit and lossless frames through the
    compat decode inline (``_device_eligible`` keeps ``precision == 8``),
    equal to ``decode_bytes``; the 8-bit frames beside them are unchanged."""
    twelve = [_encode(ref_enc, k, (2, 2), 12) for k in ("sof1", "sof9", "sof2")]
    ll = [lossless.encode_lossless(_image(5, 8), predictor=p,
                                   restart_interval=r)
          for p, r in ((1, 0), (4, 17))]
    ll.append(lossless.encode_lossless(_image(6, 12), predictor=2,
                                       precision=12))
    eight = [enc.encode_rgb(_image(9 + i, 8), restart_interval_mcus=2)
             for i in range(6)]
    items = twelve + ll + eight
    want = [decode_bytes(d, device="cpu") for d in items]
    batched = BatchedCorpusDecoder(workers=2, hybrid_device=True,
                                   device_batch=2, device="cpu")
    for decoder in (batched, CorpusDecoder(workers=2, device="cpu"),
                    CorpusDecoder(workers=2, path="fast", device="cpu")):
        res = decoder.decode_all(items)
        assert all(r.ok for r in res), [r.error for r in res if not r.ok]
        for r, w, d in zip(res, want, items):
            if d in eight and decoder is not batched:
                continue
            if d in eight:
                _within_one(r.rgb, w)
            else:
                assert r.rgb.dtype == w.dtype
                np.testing.assert_array_equal(r.rgb, w)
    assert batched.device_frames > 0
    assert not BatchedCorpusDecoder._device_eligible(parse_jpeg(twelve[0]))


def test_sixteen_bit_ppm_read_matches_jax(tmp_path):
    img = np.random.default_rng(2).integers(0, 4096, (5, 7, 3)).astype(
        np.uint16)
    for binary in (True, False):
        path = str(tmp_path / f"x{int(binary)}.ppm")
        ppm.write_ppm(path, img, binary=binary)
        got, maxval = ppm.read_ppm(path, return_maxval=True)
        want, ref_max = ref_ppm.read_ppm(path, return_maxval=True)
        assert maxval == ref_max == 4095 and got.dtype == np.uint16
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, img)


def _not_ported_calls(path) -> int:
    """How many ``not_ported(...)`` calls a source makes."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return sum(isinstance(n, ast.Call) and getattr(n.func, "id", None)
               == "not_ported" for n in ast.walk(tree))


def test_only_items_eight_and_nine_stay_unported(tmp_path, capsys,
                                                 monkeypatch):
    """Items 9 and 8 (scale-out), the last, are ported: no module of
    the port raises a 'Still to port' item or keeps the helper that raised
    one, and the two routes that raised item 8 run on the CPU:
    ``decode_batch(mesh=...)`` (equal to the unsharded call) and ``corpus
    --distributed`` (one process of one without a configured group)."""
    from jpeg_tpu_torch import cli
    from jpeg_tpu_torch.parallel.mesh import make_mesh

    pkg = os.path.join(REPO, "jpeg_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    text = f.read()
                assert _not_ported_calls(path) == 0, path
                for gone in ("Still to port", "not ported to"):
                    assert gone not in text, (path, gone)
    assert not hasattr(dec, "not_ported")

    streams = [enc.encode_rgb(synthetic_image(40, 24, seed=s), quality=85)
               for s in range(4)]
    plans = [parse_jpeg(d) for d in streams]
    geom = dec.PipelineGeometry.of(plans[0])
    coeffs = np.stack([dec.decode_coefficients_host(p).copy() for p in plans])
    mats = np.stack([dec.plan_matrices(p) for p in plans])
    mesh = make_mesh(n_data=2, n_seg=2, devices=["cpu"] * 4)
    assert torch.equal(decode_batch(coeffs, mats, geom, mesh=mesh),
                       decode_batch(coeffs, mats, geom, device="cpu"))

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    d = tmp_path / "corpus"
    d.mkdir()
    for i, data in enumerate(streams):
        (d / f"img{i}.jpg").write_bytes(data)
    capsys.readouterr()
    assert cli.main(["corpus", str(d), "--distributed", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["process_count"] == 1 and report["aggregate"]["decoded"] == 4
