"""jpeg_tpu_torch's corpus decoders on a corpus of every stream kind, and
``decode_batch``.

The corpus mixes baseline Huffman frames with restart markers (which the
hybrid route's device thread claims), progressive Huffman, SOF9, SOF10,
progressive gray, CMYK, YCCK, RGB-direct, 12-bit and lossless streams, plus
an item that must become an error record: bytes that are not a JPEG (the
12-bit and lossless items were error records too until ROADMAP items 3b and
7 were ported). Each decoded item equals the single-image decode of its
route: ``decode_bytes(path="fast")`` for 8-bit gray and YCbCr streams in the
batched decoder (K1's twin), ``decode_bytes()`` (compat) for the others.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from jpeg_tpu.entropy.lossless import encode_lossless
from jpeg_tpu.io.corpus import synthetic_image
from jpeg_tpu.models import decoder as ref_dec
from jpeg_tpu.models.encoder import encode_cmyk, encode_rgb, encode_rgb_progressive
from jpeg_tpu.parallel import batch as ref_batch
from jpeg_tpu_torch import (
    BatchedCorpusDecoder,
    CorpusDecoder,
    decode_batch,
    decode_bytes,
)
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.models import decoder as dec
from jpeg_tpu_torch.parallel import pipeline
from jpeg_tpu_torch.parallel.mesh import make_mesh


def _pil(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _mixed():
    """(items, kinds): kinds name each item's expected route."""
    img = synthetic_image(96, 64, seed=40)
    pimg = Image.fromarray(img)
    other = {
        "prog": (_pil(pimg, quality=85, progressive=True), "k1"),
        "prog_same_geometry": (_pil(Image.fromarray(
            synthetic_image(96, 64, seed=41)), quality=85, progressive=True),
            "k1"),
        "sof9": (encode_rgb(img, quality=85, arithmetic=True,
                            restart_interval_mcus=2), "k1"),
        "sof10": (encode_rgb_progressive(img, quality=85, arithmetic=True),
                  "k1"),
        "gray_prog": (_pil(pimg.convert("L"), quality=85, progressive=True),
                      "k1"),
        "cmyk": (_pil(pimg.convert("CMYK"), quality=85), "compat"),
        "cmyk_prog": (_pil(pimg.convert("CMYK"), quality=85,
                           progressive=True), "compat"),
        "ycck": (encode_cmyk(np.asarray(pimg.convert("CMYK")), quality=85,
                             ycck=True), "compat"),
        "rgb": (_pil(pimg, quality=85, keep_rgb=True), "compat"),
        "bad": (b"not a jpeg", "JPEGError"),
        "12-bit": (encode_rgb(img.astype(np.uint16) * 16, quality=90,
                              precision=12, engine="python"), "compat"),
        "lossless": (encode_lossless(img), "compat"),
    }
    # Baseline frames with restart markers last: the device thread claims
    # from the back.
    base = [encode_rgb(synthetic_image(96, 64, seed=i), quality=85,
                       restart_interval_mcus=3) for i in range(8)]
    items = [d for d, _ in other.values()] + base
    kinds = [k for _, k in other.values()] + ["k1"] * len(base)
    return items, kinds


@pytest.fixture(scope="module")
def mixed():
    return _mixed()


def _check(results, items, kinds, fast_k1: bool):
    assert len(results) == len(items)
    for r, data, kind in zip(results, items, kinds):
        if kind in ("k1", "compat"):
            assert r.ok, r.error
            path = "fast" if kind == "k1" and fast_k1 else "compat"
            np.testing.assert_array_equal(
                r.rgb, decode_bytes(data, path=path, device="cpu"))
        else:
            assert not r.ok and kind in r.error, (kind, r.error)
            if kind != "JPEGError":
                assert "ROADMAP.md" in r.error


@pytest.mark.parametrize("path", ["compat", "fast"])
def test_corpus_decoder_equals_decode_bytes(mixed, path):
    items, kinds = mixed
    dec_ = CorpusDecoder(workers=3, path=path, device="cpu")
    _check(dec_.decode_all(items), items, kinds, fast_k1=path == "fast")
    streamed = list(dec_.decode_iter(items))
    dec_.close()
    _check(streamed, items, kinds, fast_k1=path == "fast")


@pytest.mark.parametrize("hybrid", [False, True])
def test_batched_decoder_every_stream_kind(mixed, hybrid):
    """K1-route items share buckets by geometry (the two 96x64 progressive
    frames and the baseline ones share one), compat items are decoded
    inline, error items are records."""
    items, kinds = mixed
    bd = BatchedCorpusDecoder(workers=2, hybrid_device=hybrid, device_batch=2,
                              device="cpu")
    res = bd.decode_all(items)
    bd.close()
    _check(res, items, kinds, fast_k1=True)
    geoms = {dec.PipelineGeometry.of(parse_jpeg(d))
             for d, k in zip(items, kinds) if k == "k1"}
    assert bd.pixel_launches == len(geoms) < sum(k == "k1" for k in kinds)
    if hybrid:
        assert bd.device_frames > 0 and bd.entropy_launches > 0


def test_worker_copies_progressive_planes():
    """Two progressive frames of one geometry through one worker thread:
    each result is its own frame (the worker copies the runtime's scratch
    planes before decoding the next)."""
    items = [_pil(Image.fromarray(synthetic_image(96, 64, seed=s)),
                  quality=85, progressive=True) for s in (1, 2, 1)]
    res = BatchedCorpusDecoder(workers=1, device="cpu").decode_all(items)
    for r, data in zip(res, items):
        np.testing.assert_array_equal(
            r.rgb, decode_bytes(data, path="fast", device="cpu"))
    assert not np.array_equal(res[0].rgb, res[1].rgb)
    np.testing.assert_array_equal(res[0].rgb, res[2].rgb)


def test_corpus_decoder_does_not_hide_a_device_failure(monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("simulated CUDA error")

    monkeypatch.setattr(pipeline, "decode_plan", boom)
    with pytest.raises(RuntimeError, match="simulated CUDA error"):
        CorpusDecoder(workers=1, device="cpu").decode_all(_mixed()[0][:1])
    with pytest.raises(RuntimeError, match="simulated CUDA error"):
        BatchedCorpusDecoder(workers=1, device="cpu").decode_all(
            [_pil(Image.fromarray(synthetic_image(32, 32, 1)).convert("CMYK"))])


def test_corpus_decoders_raise_a_device_not_implemented_error(monkeypatch):
    """PyTorch raises ``NotImplementedError`` (a ``RuntimeError``) for an op
    with no CUDA kernel for a dtype: a device failure, not the image's, so
    it leaves ``decode_all`` instead of becoming an error record."""
    def boom(*args, **kwargs):
        raise NotImplementedError("simulated: no CUDA kernel for UInt16")

    monkeypatch.setattr(pipeline, "decode_plan", boom)
    with pytest.raises(NotImplementedError, match="UInt16"):
        CorpusDecoder(workers=1, device="cpu").decode_all(_mixed()[0][:1])
    with pytest.raises(NotImplementedError, match="UInt16"):
        BatchedCorpusDecoder(workers=1, device="cpu").decode_all(
            [_pil(Image.fromarray(synthetic_image(32, 32, 1)).convert("CMYK"))])


def test_corpus_decoder_options():
    with pytest.raises(ValueError, match="path"):
        CorpusDecoder(path="slow", device="cpu")
    assert CorpusDecoder(idct_mode="approx", device="cpu").idct_mode == "approx"
    with pytest.raises(ValueError, match="idct_mode"):
        CorpusDecoder(idct_mode="fast", device="cpu")


@pytest.mark.parametrize("rounding", ["truncate", "round"])
@pytest.mark.parametrize("sub", [(2, 2), (1, 1), None])
def test_decode_batch_equals_decode_plan(sub, rounding):
    """The compat pipeline over a bucket (one product per component for the
    batch) equals per-image decode_plan, and is within +-1 u8 of the JAX
    package's decode_batch; sharded over a mesh it equals itself."""
    gray = sub is None
    streams = [encode_rgb(synthetic_image(88, 56, seed=s)[..., 0] if gray
                          else synthetic_image(88, 56, seed=s), quality=85,
                          subsampling=sub or (1, 1), grayscale=gray)
               for s in range(3)]
    plans = [parse_jpeg(d) for d in streams]
    geom = dec.PipelineGeometry.of(plans[0])
    coeffs = np.stack([dec.decode_coefficients_host(p).copy() for p in plans])
    mats = np.stack([dec.plan_matrices(p) for p in plans])
    got = decode_batch(coeffs, mats, geom, rounding, device="cpu")
    assert isinstance(got, torch.Tensor) and got.shape == (3, 56, 88, 3)
    for g, p in zip(got.numpy(), plans):
        np.testing.assert_array_equal(g, dec.decode_plan(p, rounding,
                                                         device="cpu"))
    ref_geom = ref_dec.PipelineGeometry(**vars(geom))
    want = np.asarray(ref_batch.decode_batch(coeffs, mats, ref_geom, rounding))
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05
    mesh = make_mesh(n_data=3, devices=["cpu"] * 3)
    assert torch.equal(decode_batch(coeffs, mats, geom, rounding, mesh), got)
