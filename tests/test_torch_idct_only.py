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
