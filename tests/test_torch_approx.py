"""K1a, the approx IDCT tier (``idct_mode="approx"``), on the CPU: its plain
twin against an emulation of the TPU's DEFAULT-precision pass built from the
JAX package's own pieces, against the quality gate of
``docs/APPROX_QUALITY.md`` on every sampling, and through every entry point
that takes ``idct_mode``; and K1, its exact sibling, unchanged.

On a TPU, ``Precision.DEFAULT`` is one bf16 pass of the MXU: both operands
of each IDCT product rounded to bf16, the products summed in fp32. On the
CPU the JAX package's DEFAULT is full fp32 (its approx and exact tiers are
identical there), so the emulation rounds the operands itself.
"""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from PIL import Image

from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu.io.corpus import synthetic_image
from jpeg_tpu.models import decoder as ref_dec
from jpeg_tpu.models.encoder import encode_rgb
from jpeg_tpu.ops.idct import dct_basis_1d as ref_basis
from jpeg_tpu.ops.pallas_kernels import _kron_eye
from jpeg_tpu_torch import BatchedCorpusDecoder, CorpusDecoder, decode_bytes
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.models.decoder import PipelineGeometry, decode_plan_fast
from jpeg_tpu_torch.ops import fused_plane as k1
from jpeg_tpu_torch.ops.idct import (
    bf16_round,
    dct_basis_1d_bf16,
    idct_blocks_plain,
)
from jpeg_tpu_torch.parallel.batch import decode_batch_fast
from jpeg_tpu_torch.runtime import native_decode_planes

# The quality gate of docs/APPROX_QUALITY.md, against the exact tier.
GATE_MAX_DIFF = 2
GATE_PSNR_DB = 50.0
# The emulation's XLA dot sums the block-diagonal products in index order
# (the zeros add exactly), as the twin does, and agrees bit for bit on these
# planes; a matrix unit may sum in another order, which fp32 rounding bounds
# far below this relative tolerance.
EMULATION_REL_TOL = 1e-6

SAMPLINGS = {"1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2),
             "4x1": (4, 1), "4x4": (4, 4), "gray": None}


def _stream(sampling, seed=3, size=(136, 200), quality=92) -> bytes:
    rng = np.random.default_rng(seed)
    img = synthetic_image(size[1], size[0], seed=seed).astype(np.int16)
    img = np.clip(img + rng.integers(-30, 30, img.shape), 0, 255).astype(np.uint8)
    sub = SAMPLINGS[sampling]
    if sub is None:
        return encode_rgb(img[..., 0], quality=quality, grayscale=True)
    return encode_rgb(img, quality=quality, subsampling=sub)


def _psnr(a, b) -> float:
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _gate(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= GATE_MAX_DIFF
    assert _psnr(got, want) >= GATE_PSNR_DB


def _bf16_jax(x):
    return jnp.asarray(x, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32)


def test_bf16_basis_is_the_tpu_operand_and_mirror_symmetric():
    """K1a's basis is JAX's bf16 rounding of the float32 basis, and keeps
    the mirror symmetry A[v][7-y] = (-1)^v A[v][y] bit for bit (rounding to
    nearest even is symmetric in sign)."""
    a = dct_basis_1d_bf16()
    np.testing.assert_array_equal(a, np.asarray(_bf16_jax(ref_basis())))
    sign = np.where(np.arange(8) % 2, -1.0, 1.0).astype(np.float32)[:, None]
    np.testing.assert_array_equal(a[:, ::-1].view(np.uint32),
                                  (a * sign).view(np.uint32))
    x = torch.tensor([1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -(1.0 + 2.0**-8), 0.0])
    np.testing.assert_array_equal(  # ties to even, in both signs
        bf16_round(x).numpy(), [1.0, 1.0 + 2.0**-6, -1.0, 0.0])


def test_bf16_products_are_exact_in_fp32():
    """K1a's tensor cores multiply bf16 operands exactly, and the twin's
    rounded fp32 products are exact too, so the two differ only in the order
    and rounding of their sums. Each basis value times every finite
    bf16 value from 2^-40 to 2^40 (both signs) is exact: fp32 product ==
    float64 product. The IDCT's operands lie inside that range: a nonzero
    dequantised value is an integer of at least 1 and below 2^23 (an int16
    coefficient times a table entry below 256), and the vertical pass's
    terms are multiples of 2^-11 (basis values are multiples of 2^-11), so
    a nonzero intermediate is at least 2^-11."""
    bits = np.arange(0, 1 << 16, dtype=np.uint32) << 16
    vals = bits.view(np.float32)
    vals = vals[np.isfinite(vals) & (np.abs(vals) >= 2.0**-40)
                & (np.abs(vals) <= 2.0**40)]
    for a in np.unique(dct_basis_1d_bf16()):
        prod32 = np.float32(a) * vals
        np.testing.assert_array_equal(prod32.astype(np.float64),
                                      np.float64(a) * vals.astype(np.float64))


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_twin_matches_tpu_default_pass_emulation(sampling):
    """The twin's IDCT of each plane against the TPU kernel's sandwich at
    DEFAULT precision, emulated with the JAX package's pieces: the
    block-diagonal kron(I, A^T) and kron(I, A) of ``_kron_eye``, each
    operand of both ``jnp.dot``s rounded to bf16, fp32 products summed."""
    plan = parse_jpeg(_stream(sampling))
    geom = PipelineGeometry.of(plan)
    q = k1.plan_quant_patterns(plan, geom)
    a = ref_basis()
    for ci, p in enumerate(native_decode_planes(plan)):
        rows, cols = p.shape
        f = p.astype(np.float32) * np.tile(q[ci].reshape(8, 8),
                                           (rows // 8, cols // 8))
        t = jnp.dot(_bf16_jax(_kron_eye(a.T, rows // 8)), _bf16_jax(f),
                    precision=lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
        want = np.asarray(jnp.dot(_bf16_jax(t), _bf16_jax(_kron_eye(a, cols // 8)),
                                  precision=lax.Precision.HIGHEST,
                                  preferred_element_type=jnp.float32))
        got = idct_blocks_plain(
            torch.from_numpy(f).view(rows // 8, 8, cols // 8, 8),
            torch.from_numpy(dct_basis_1d_bf16()), bf16=True)
        got = got.reshape(rows, cols).numpy()
        bar = EMULATION_REL_TOL * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= bar


@pytest.mark.parametrize("rounding", ["truncate", "round"])
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_twin_within_gate_of_jax_exact(sampling, rounding):
    """``decode_plan_fast(idct_mode="approx")`` within max |diff| <= 2 u8
    and >= 50 dB of the JAX package's exact ``decode_plan_fast`` (Pallas
    interpret), and of the port's exact tier."""
    data = _stream(sampling)
    got = decode_plan_fast(parse_jpeg(data), rounding, "cpu", "approx")
    want = np.asarray(ref_dec.decode_plan_fast(ref_parse(data), rounding))
    _gate(got, want)
    _gate(got, decode_plan_fast(parse_jpeg(data), rounding, "cpu"))
    # The JAX package's approx tier is its exact tier on the CPU.
    np.testing.assert_array_equal(
        np.asarray(ref_dec.decode_plan_fast(ref_parse(data), rounding,
                                            idct_mode="approx")), want)


def test_twin_within_gate_on_a_4k_fixture_frame():
    """The main path's frame: within the gate of exact K1's twin, with
    values differing (the tier does round)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                           "torch", "synth_3840x2160_s0_q85_rst1.jpg"), "rb") as f:
        data = f.read()
    exact = decode_bytes(data, path="fast", device="cpu")
    approx = decode_bytes(data, path="fast", idct_mode="approx", device="cpu")
    _gate(approx, exact)
    assert (approx != exact).any()


def test_every_entry_point_takes_the_approx_tier():
    """decode_bytes, decode_plan_fast, decode_batch_fast, CorpusDecoder and
    BatchedCorpusDecoder (host and hybrid) give one image the same approx
    pixels; the compat path and the colour models K1 does not take stay
    exact, as in the JAX package."""
    streams = [encode_rgb(synthetic_image(96, 64, seed=s), quality=85,
                          restart_interval_mcus=2) for s in range(3)]
    plans = [parse_jpeg(d) for d in streams]
    want = [decode_plan_fast(p, device="cpu", idct_mode="approx") for p in plans]
    for w, d in zip(want, streams):
        np.testing.assert_array_equal(
            decode_bytes(d, path="fast", idct_mode="approx", device="cpu"), w)
        # compat ignores idct_mode
        np.testing.assert_array_equal(
            decode_bytes(d, idct_mode="approx", device="cpu"),
            decode_bytes(d, device="cpu"))
    geom = PipelineGeometry.of(plans[0])
    bp = [np.stack([native_decode_planes(p)[c].copy() for p in plans])
          for c in range(3)]
    bq = np.stack([k1.plan_quant_patterns(p, geom) for p in plans])
    planar = decode_batch_fast(bp, bq, geom, device="cpu", idct_mode="approx")
    for b, w in enumerate(want):
        np.testing.assert_array_equal(
            planar[b, :, :64, :96].permute(1, 2, 0).numpy(), w)
    for dec in (CorpusDecoder(path="fast", idct_mode="approx", device="cpu"),
                BatchedCorpusDecoder(idct_mode="approx", device="cpu"),
                BatchedCorpusDecoder(idct_mode="approx", hybrid_device=True,
                                     device_batch=1, workers=1, device="cpu")):
        res = dec.decode_all(streams)
        dec.close()
        for r, w in zip(res, want):
            assert r.ok
            np.testing.assert_array_equal(r.rgb, w)
    buf = io.BytesIO()
    Image.fromarray(synthetic_image(48, 32, seed=1)).convert("CMYK").save(
        buf, "JPEG", quality=90)
    cmyk = buf.getvalue()
    np.testing.assert_array_equal(
        decode_bytes(cmyk, path="fast", idct_mode="approx", device="cpu"),
        decode_bytes(cmyk, device="cpu"))
    with pytest.raises(ValueError, match="idct_mode"):
        decode_bytes(streams[0], path="fast", idct_mode="fast", device="cpu")
    with pytest.raises(ValueError, match="idct_mode"):
        BatchedCorpusDecoder(idct_mode="bf16", device="cpu")


@pytest.mark.parametrize("sampling", ["2x2", "gray", "4x4"])
def test_exact_sibling_unchanged(sampling):
    """K1's twin with ``idct_mode="exact"`` is the call without it, the IDCT
    without ``bf16`` is the one K1 always had (unrounded operands), and the
    approx tier differs from it."""
    plan = parse_jpeg(_stream(sampling, seed=5))
    geom = PipelineGeometry.of(plan)
    planes = [torch.from_numpy(p.copy()).unsqueeze(0)
              for p in native_decode_planes(plan)]
    qt = torch.from_numpy(k1.plan_quant_patterns(plan, geom)).unsqueeze(0)
    base = k1.fused_plane_decode_plain(planes, qt, geom)
    for rounding in ("truncate", "round"):
        assert torch.equal(
            k1.fused_plane_decode(planes, qt, geom, rounding, "exact"),
            k1.fused_plane_decode_plain(planes, qt, geom, rounding))
    approx = k1.fused_plane_decode(planes, qt, geom, idct_mode="approx")
    assert not torch.equal(approx, base)
    f = torch.from_numpy(np.random.default_rng(0).normal(0, 300, (2, 8, 3, 8))
                         .astype(np.float32))
    a = torch.tensor(ref_basis(), dtype=torch.float32)
    t = torch.einsum("vy,rvcu->rycu", a, f)  # the exact operands' IDCT
    want = torch.einsum("rycu,ux->rycx", t, a)
    np.testing.assert_allclose(idct_blocks_plain(f, a).numpy(), want.numpy(),
                               rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="idct_mode"):
        k1.fused_plane_decode_plain(planes, qt, geom, idct_mode="half")
    assert k1.LAUNCHES.value == 0 and k1.LAUNCHES_APPROX.value == 0
