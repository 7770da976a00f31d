"""K1 (fused pixel stage) plain version vs jpeg_tpu's Pallas kernel in
interpret mode, and the device-block relayout vs its JAX counterpart.

Bar for pixels: max |diff| <= 1 u8 and under 5% of pixels differing, the
repo's own bar between its fused and compat tiers (tests/test_fast_path.py):
the TPU kernel runs its IDCT as block-diagonal matmuls, K1 as ordered fp32
sums, so rounding flips at truncation boundaries are expected."""

import numpy as np
import pytest
import torch

from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu.models.decoder import PipelineGeometry as RefGeometry
from jpeg_tpu.models.decoder import coefficient_planes_from_blocks as ref_relayout
from jpeg_tpu.models.encoder import encode_rgb
from jpeg_tpu.ops.pallas_kernels import decode_planes_fused as ref_fused
from jpeg_tpu.ops.pallas_kernels import padded_plane_shapes as ref_shapes
from jpeg_tpu.ops.pallas_kernels import plan_quant_patterns as ref_qpats
from jpeg_tpu.parallel.batch import decode_batch_fast as ref_batch
from jpeg_tpu.runtime import native_decode_coefficients
from jpeg_tpu.runtime import native_decode_planes as ref_planes
from jpeg_tpu_torch.io.container import plan_from_reference
from jpeg_tpu_torch.models.decoder import (
    PipelineGeometry,
    coefficient_planes_from_blocks,
)
from jpeg_tpu_torch.ops.fused_plane import (
    decode_planes_fused,
    fused_plane_decode,
    padded_plane_shapes,
    plan_quant_patterns,
)
from jpeg_tpu_torch.parallel.batch import decode_batch_fast


def _assert_within_one(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.05


def _ref_plan(seed, shape=(72, 104), **enc):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    gray = enc.pop("gray", False)
    return ref_parse(encode_rgb(img[..., 0] if gray else img, grayscale=gray,
                                **enc))


CASES = [
    dict(subsampling=(2, 2), quality=90),
    dict(subsampling=(2, 1), quality=80),
    dict(subsampling=(1, 2), quality=85),
    dict(subsampling=(1, 1), quality=95),
    dict(gray=True, quality=85),
    dict(subsampling=(4, 1), quality=90),
    dict(subsampling=(4, 4), quality=90),
]


@pytest.mark.parametrize("rounding", ["truncate", "round"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_single_image_matches_pallas_kernel(case, rounding):
    ref = _ref_plan(case, **dict(CASES[case], restart_interval_mcus=2))
    planes = [p.copy() for p in ref_planes(ref)]
    want = np.asarray(ref_fused(planes, ref, rounding, interpret=True))
    got = decode_planes_fused(planes, plan_from_reference(ref), rounding,
                              device="cpu")
    _assert_within_one(got, want)


@pytest.mark.parametrize("rounding", ["truncate", "round"])
def test_batch_matches_vmapped_pallas_kernel(rounding):
    """Images of one geometry with different quant tables in one launch."""
    refs = [_ref_plan(20 + i, quality=q, subsampling=(2, 2))
            for i, q in enumerate((60, 85, 97))]
    geom = RefGeometry.of(refs[0])
    bp = [np.stack([ref_planes(p)[c].copy() for p in refs]) for c in range(3)]
    bq = [np.stack([ref_qpats(p, geom)[c] for p in refs]) for c in range(3)]
    want = np.asarray(ref_batch(bp, bq, geom, rounding, interpret=True))
    port = [plan_from_reference(p) for p in refs]
    pgeom = PipelineGeometry.of(port[0])
    qt = np.stack([plan_quant_patterns(p, pgeom) for p in port])
    got = decode_batch_fast(bp, qt, pgeom, rounding, device="cpu")
    assert got.device.type == "cpu"
    _assert_within_one(got.numpy(), want)


@pytest.mark.parametrize("case", [0, 1, 4, 6])
def test_shapes_match_jax_layout(case):
    ref = _ref_plan(case, shape=(300, 520), **CASES[case])
    port = PipelineGeometry.of(plan_from_reference(ref))
    assert padded_plane_shapes(port) == ref_shapes(RefGeometry.of(ref))


@pytest.mark.parametrize("case", [0, 2, 4, 6])
def test_coefficient_planes_from_blocks_exact(case):
    """Device-block relayout == the JAX relayout == the C++ plane output."""
    ref = _ref_plan(case, **CASES[case])
    blocks = native_decode_coefficients(ref, reuse_buffer=False)
    want = ref_relayout(blocks, RefGeometry.of(ref))
    got = coefficient_planes_from_blocks(
        torch.from_numpy(blocks), PipelineGeometry.of(plan_from_reference(ref)))
    for g, w, n in zip(got, want, ref_planes(ref)):
        assert g.dtype == torch.int16
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), n)


def test_relayout_wraps_like_int16():
    """Out-of-range coefficients (corrupt DC sums) wrap like the JAX cast."""
    ref = _ref_plan(3, **CASES[3])
    blocks = native_decode_coefficients(ref, reuse_buffer=False).copy()
    blocks[::7, 0] += 70000
    want = ref_relayout(blocks, RefGeometry.of(ref))
    got = coefficient_planes_from_blocks(
        torch.from_numpy(blocks), PipelineGeometry.of(plan_from_reference(ref)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrapper_checks_inputs():
    ref = _ref_plan(1, **CASES[0])
    port = plan_from_reference(ref)
    geom = PipelineGeometry.of(port)
    planes = [torch.from_numpy(p.copy()).unsqueeze(0) for p in ref_planes(ref)]
    qt = torch.from_numpy(plan_quant_patterns(port, geom)).unsqueeze(0)
    with pytest.raises(ValueError, match="int16"):
        fused_plane_decode([p.to(torch.int32) for p in planes], qt, geom)
    with pytest.raises(ValueError, match="rounding"):
        fused_plane_decode(planes, qt, geom, rounding="nearest")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_plane_decode([p.to("meta") for p in planes], qt.to("meta"), geom)


@pytest.mark.parametrize("v", range(8))
def test_basis_mirror_symmetry_is_exact_in_float32(v):
    """K1 computes A[v][y] * F once for outputs y and 7 - y, negated for
    odd v: exact only because the float32 basis row is mirror-symmetric bit
    for bit, and equal to the JAX package's."""
    from jpeg_tpu.ops.idct import dct_basis_1d as ref_basis
    from jpeg_tpu_torch.ops.idct import dct_basis_1d

    a = dct_basis_1d().astype(np.float32)[v]
    np.testing.assert_array_equal(a[::-1], a if v % 2 == 0 else -a)
    np.testing.assert_array_equal(a, ref_basis().astype(np.float32)[v])


@pytest.mark.parametrize("h_max,v_max,sampling", [
    (1, 3, ((1, 3), (1, 1), (1, 1))),  # chroma factor 3 vertically
    (3, 1, ((3, 1), (2, 1), (2, 1))),  # h_max 3 against h 2: no whole factor
    (2, 2, ((2, 2), (1, 0), (1, 1))),  # a factor below 1
])
def test_wrapper_refuses_factors_k1_does_not_take(h_max, v_max, sampling):
    """K1 (kernel and twin alike) takes upsampling factors of 1, 2 or 4 that
    divide the maxima, as K2's launcher does; the twin would otherwise
    repeat by 3 where the kernel cannot."""
    geom = PipelineGeometry(width=64, height=48, mcus_x=2, mcus_y=2,
                            h_max=h_max, v_max=v_max, sampling=sampling)
    planes = [torch.zeros((1, 128, 256), dtype=torch.int16) for _ in sampling]
    qt = torch.ones((1, 3, 64), dtype=torch.float32)
    with pytest.raises(ValueError, match="factors of 1, 2 or 4"):
        fused_plane_decode(planes, qt, geom)
