"""K5 / K6 (bare dequant + 8x8 IDCT) plain versions vs jpeg_tpu's
``idct_only_kernel`` / ``idct_only_kernel_roll`` (Pallas, interpret mode)
on seeded int16 planes, and the host tables held to their originals.

Tolerance: max |port - JAX| <= 1e-6 x max |JAX out|. The JAX kernels sum
through XLA's dot and (on the CPU) fused multiply-adds, the port in
ascending order with every product rounded: both sit within ~6e-3 of a
float64 reference at outputs of ~5e4 (~1.3e-7 relative), so the bar is ~8x
the largest difference seen and far below what a wrong basis or index
gives."""

import numpy as np
import pytest
import torch

from jpeg_tpu.ops import pallas_kernels as pk
from jpeg_tpu_torch.ops import idct_only as k56
from jpeg_tpu_torch.ops.idct import dct_basis_1d

REL_TOL = 1e-6
SHAPES = [(128, 256), (256, 512)]
KERNELS = {"K5": (k56.idct_only_kernel, pk.idct_only_kernel),
           "K6": (k56.idct_only_kernel_roll, pk.idct_only_kernel_roll)}


def _inputs(rows, cols, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-512, 512, (rows, cols)).astype(np.int16)
    return x, pk.quant_pattern(np.arange(1, 65), 128, 256)


def _float64_reference(x, qpat):
    rows, cols = x.shape
    f = (x.astype(np.float64) * np.tile(qpat, (rows // 128, cols // 256))
         ).reshape(rows // 8, 8, cols // 8, 8)
    a = dct_basis_1d()
    return np.einsum("vy,bvcu,ux->bycx", a, f, a).reshape(rows, cols)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_matches_jax_interpret(kernel, shape):
    port, jax_builder = KERNELS[kernel]
    x, qpat = _inputs(*shape, seed=len(kernel) + shape[0])
    want = np.asarray(jax_builder(*shape, interpret=True)(x, qpat))
    got = port(*shape)(torch.from_numpy(x), torch.from_numpy(qpat))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    bar = REL_TOL * float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= bar
    # The float64 reference meets the same bar against the JAX kernel.
    assert float(np.abs(_float64_reference(x, qpat) - want).max()) <= bar


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_twins_agree_by_value(shape):
    """The masked terms of K6 add exact zeros: equal values (the sign of a
    zero may differ, which ``torch.equal`` does not see)."""
    x, qpat = (torch.from_numpy(a) for a in _inputs(*shape, seed=9))
    a = k56.idct_only_plain(x, qpat)
    b = k56.idct_only_roll_plain(x, qpat)
    assert torch.equal(a, b)


def test_wrappers_take_plain_version_on_cpu():
    x, qpat = (torch.from_numpy(a) for a in _inputs(128, 256, seed=3))
    before = (k56.LAUNCHES.value, k56.LAUNCHES_ROLL.value)
    assert torch.equal(k56.idct_only(x, qpat), k56.idct_only_plain(x, qpat))
    assert torch.equal(k56.idct_only_roll(x, qpat),
                       k56.idct_only_roll_plain(x, qpat))
    assert (k56.LAUNCHES.value, k56.LAUNCHES_ROLL.value) == before
    meta = torch.empty((128, 256), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        k56.idct_only(meta, qpat.to("meta"))


@pytest.mark.parametrize("rows,cols,quant", [
    (128, 256, np.arange(1, 65)), (256, 512, np.full(64, 16)),
    (8, 16, np.arange(64)[::-1])])
def test_quant_pattern_matches_jax(rows, cols, quant):
    got = k56.quant_pattern(quant, rows, cols)
    want = pk.quant_pattern(quant, rows, cols)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("forward", [False, True])
def test_roll_tables_match_jax(forward):
    for d in range(-7, 8):
        np.testing.assert_array_equal(
            k56.roll_mask_vector(40, d, transpose_a=forward),
            pk.roll_mask_vector(40, d, transpose_a=forward))
    for got, want in zip(k56.roll_masks(128, 256, forward),
                         pk.roll_masks(128, 256, forward)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows,cols", [(64, 256), (128, 128), (128, 300),
                                       (0, 256)])
@pytest.mark.parametrize("kernel", KERNELS)
def test_builders_refuse_off_grid_shapes(kernel, rows, cols):
    with pytest.raises(ValueError, match="whole"):
        KERNELS[kernel][0](rows, cols)


def test_run_refuses_other_shapes_and_types():
    run = k56.idct_only_kernel(128, 256)
    x, qpat = (torch.from_numpy(a) for a in _inputs(256, 256 * 2, seed=1))
    with pytest.raises(ValueError, match="built for"):
        run(x, qpat)
    with pytest.raises(ValueError, match="int16"):
        run(torch.zeros((128, 256), dtype=torch.int32), qpat)
    with pytest.raises(ValueError, match="qpat"):
        run(torch.zeros((128, 256), dtype=torch.int16), qpat[:64])


# The redesign's claims, checked in float32 NumPy (each operation rounded,
# as on the card with --fmad=false): K6's 15 terms a pass are its 8 unmasked
# terms summed from +0, and the kernels' body (idct8x8.cuh) gives each twin
# bit for bit.


def _sum8(terms, zero_start):
    acc = np.zeros_like(terms[0]) if zero_start else terms[0]
    for t in (terms if zero_start else terms[1:]):
        acc = acc + t
    return acc


def _ordered_model(x, qpat, zero_start):
    """Eight terms a pass in ascending order, from +0 or from the first."""
    rows, cols = x.shape
    f = (x.astype(np.float32).reshape(rows // 128, 128, cols // 256, 256)
         * qpat.reshape(1, 128, 1, 256)).reshape(rows // 8, 8, cols // 8, 8)
    a = dct_basis_1d().astype(np.float32)
    t = _sum8([a[v].reshape(1, 8, 1, 1) * f[:, v:v + 1] for v in range(8)],
              zero_start)
    s = _sum8([t[..., u:u + 1] * a[u] for u in range(8)], zero_start)
    return s.reshape(rows, cols)


def _kernel_model(x, qpat, zero_start):
    """idct8x8.cuh as written: each product of the first half of the
    outputs also serves the mirrored output, negated for odd terms; the
    vertical pass starts from its first product, the horizontal one from +0
    where ``zero_start`` (K6)."""
    rows, cols = x.shape
    f = (x.astype(np.float32).reshape(rows // 128, 128, cols // 256, 256)
         * qpat.reshape(1, 128, 1, 256)).reshape(rows // 8, 8, cols // 8, 8)
    a = dct_basis_1d().astype(np.float32)

    def half_pass(prod, start_zero):  # prod(k, y) -> the rounded product
        out = [None] * 8
        for y in range(4):
            p0 = prod(0, y)
            lo = np.float32(0.0) + p0 if start_zero else p0
            hi = lo
            for k in range(1, 8):
                p = prod(k, y)
                lo = lo + p
                hi = hi + (-p if k & 1 else p)
            out[y], out[7 - y] = lo, hi
        return out

    t = np.stack(half_pass(lambda v, y: a[v, y] * f[:, v], False), axis=1)
    s = np.stack(half_pass(lambda u, x_: t[..., u] * a[u, x_], zero_start),
                 axis=-1)
    return s.reshape(rows, cols)


def _design_inputs(zeros, pattern, seed=0, shape=(256, 512)):
    rng = np.random.default_rng(seed)
    x = rng.integers(-512, 512, shape).astype(np.int16)
    x[rng.random(shape) < zeros] = 0
    if pattern == "tiled":
        qpat = k56.quant_pattern(np.arange(1, 65), 128, 256)
    else:  # any [128, 256] values, not periodic, zeros and negatives too
        qpat = rng.uniform(-4.0, 64.0, (128, 256)).astype(np.float32)
        qpat[rng.random((128, 256)) < 0.05] = 0.0
    return x, qpat


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("pattern", ["tiled", "random"])
@pytest.mark.parametrize("zeros", [0.0, 0.8, 1.0])
def test_eight_term_models_equal_twins_bit_for_bit(zeros, pattern):
    """K6's twin (15 terms a pass from +0, seven of them masked to +-0) is
    the 8-term sum from +0; K5's twin the 8-term sum from the first
    product. The two agree by value and K6 never gives -0."""
    x, qpat = _design_inputs(zeros, pattern, seed=int(zeros * 10))
    xt, qt = torch.from_numpy(x), torch.from_numpy(qpat)
    k5 = k56.idct_only_plain(xt, qt).numpy()
    k6 = k56.idct_only_roll_plain(xt, qt).numpy()
    np.testing.assert_array_equal(_bits(_ordered_model(x, qpat, True)), _bits(k6))
    np.testing.assert_array_equal(_bits(_ordered_model(x, qpat, False)), _bits(k5))
    np.testing.assert_array_equal(k5, k6)  # equal values
    assert not np.signbit(k6[k6 == 0]).any()


def test_k5_and_k6_differ_in_the_sign_of_zero():
    """Zero coefficients under a negative pattern: every dequantised value
    is -0, every product of the first row and column of a block is -0, and
    K5's sum of them is -0 where K6's +0 start gives +0."""
    x = np.zeros((128, 256), np.int16)
    qpat = np.full((128, 256), -1.0, np.float32)
    xt, qt = torch.from_numpy(x), torch.from_numpy(qpat)
    k5 = k56.idct_only_plain(xt, qt).numpy()
    k6 = k56.idct_only_roll_plain(xt, qt).numpy()
    assert (k5 == 0).all() and (k6 == 0).all()
    assert np.signbit(k5[::8, ::8]).all() and not np.signbit(k6).any()
    np.testing.assert_array_equal(_bits(_kernel_model(x, qpat, False)), _bits(k5))
    np.testing.assert_array_equal(_bits(_kernel_model(x, qpat, True)), _bits(k6))


@pytest.mark.parametrize("pattern", ["tiled", "random"])
@pytest.mark.parametrize("zeros", [0.0, 0.8, 1.0])
def test_kernel_body_equals_twins_bit_for_bit(zeros, pattern):
    """The shared body's arithmetic (mirrored products, the template's +0
    start on the horizontal pass only) reproduces both twins."""
    x, qpat = _design_inputs(zeros, pattern, seed=5 + int(zeros * 10))
    xt, qt = torch.from_numpy(x), torch.from_numpy(qpat)
    np.testing.assert_array_equal(_bits(_kernel_model(x, qpat, False)),
                                  _bits(k56.idct_only_plain(xt, qt).numpy()))
    np.testing.assert_array_equal(_bits(_kernel_model(x, qpat, True)),
                                  _bits(k56.idct_only_roll_plain(xt, qt).numpy()))


@pytest.mark.parametrize("v", range(8))
def test_float32_basis_is_mirror_symmetric(v):
    """A[v][7 - y] == (-1)^v A[v][y] bit for bit in float32: what lets the
    kernels share each product between outputs y and 7 - y."""
    a = dct_basis_1d().astype(np.float32)[v]
    np.testing.assert_array_equal(_bits(a[::-1]), _bits(a if v % 2 == 0 else -a))
