"""The 1-D DCT basis the pixel kernel (K1, and rounded to bf16 its approx
tier K1a), the forward kernel (K2), the bare IDCT kernels (K5, K6) and
their plain versions use; the compat decode's
fused [64, 64] dequant + unzigzag + IDCT matrix; the host encoder's forward
DCT matrix.

Copies of ``jpeg_tpu.ops.idct.dct_basis_1d``, ``fused_idct_matrix``,
``forward_dct_matrix`` and the direct-formula test twins
``idct_block_naive`` / ``dct_block_naive``. K1, K2, K5 and K6 run the separable 8x8 transform
with this basis in fp32; the compat decode multiplies by the fused matrix.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from jpeg_tpu_torch.ops.zigzag import permutation_matrix


def dct_basis_1d() -> np.ndarray:
    """A[u, x] = alpha(u)/2 * cos((2x+1) u pi / 16), float64 [8, 8].

    Same basis the reference evaluates pointwise per output pixel
    (``src/transform.rs:66-84``).
    """
    u = np.arange(8, dtype=np.float64)[:, None]
    x = np.arange(8, dtype=np.float64)[None, :]
    a = np.cos((2.0 * x + 1.0) * u * np.pi / 16.0)
    alpha = np.ones(8, dtype=np.float64)
    alpha[0] = 1.0 / np.sqrt(2.0)
    return (alpha[:, None] / 2.0) * a


def dct_basis_1d_bf16() -> np.ndarray:
    """:func:`dct_basis_1d` in float32, each value rounded to bfloat16 (K1a's
    basis, the TPU's DEFAULT-precision operand)."""
    a = torch.tensor(dct_basis_1d(), dtype=torch.float32)
    return bf16_round(a).numpy()


@lru_cache(maxsize=None)
def _idct_kron() -> np.ndarray:
    """kron(A, A): [64, 64] so that out_flat = F_flat(natural) @ K."""
    a = dct_basis_1d()
    return np.kron(a, a)


def fused_idct_matrix(quant_zz: np.ndarray, dtype=np.float32) -> np.ndarray:
    """[64, 64] matrix fusing dequant + unzigzag + IDCT for one quant table
    in zigzag order (as stored in DQT): pixels [N, 64] = coeffs_zigzag
    [N, 64] @ it. Built in float64, cast down."""
    q = np.asarray(quant_zz, dtype=np.float64).reshape(64)
    m = (q[:, None] * permutation_matrix().astype(np.float64)) @ _idct_kron()
    return m.astype(dtype)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to bfloat16 (nearest, ties to even) and widened
    back, as ``__float2bfloat16_rn`` does."""
    return x.to(torch.bfloat16).to(torch.float32)


def idct_columns_plain(f: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Vertical pass of :func:`idct_blocks_plain`: t[y][u] = sum_v A[v][y]
    F[v][u] over ``f [..., R, 8, C, 8]``, each product rounded, summed in
    ascending v from the v = 0 product."""
    t = a[0].view(8, 1, 1) * f[..., 0:1, :, :]
    for k in range(1, 8):
        t = t + a[k].view(8, 1, 1) * f[..., k:k + 1, :, :]
    return t


def idct_rows_plain(t: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Horizontal pass of :func:`idct_blocks_plain`: s[y][x] = sum_u
    t[y][u] A[u][x], in ascending u from the u = 0 product."""
    s = t[..., 0:1] * a[0]
    for k in range(1, 8):
        s = s + t[..., k:k + 1] * a[k]
    return s


def idct_blocks_plain(f: torch.Tensor, a: torch.Tensor,
                      bf16: bool = False) -> torch.Tensor:
    """Separable 8x8 IDCT of dequantised blocks ``f [..., R, 8, C, 8]``
    (block row, v, block column, u) with the basis ``a [8, 8]``, both fp32.
    Eight terms summed in index order with each product rounded, as K1 and
    K5 do: vertical pass first, t[y][u] = sum_v A[v][y] F[v][u], then
    s[y][x] = sum_u t[y][u] A[u][x].

    ``bf16=True`` is K1a's arithmetic, the TPU's one-pass bf16 product:
    ``f`` and ``t`` are rounded to bf16 before the pass that reads them
    (``a`` must be bf16-rounded already: :func:`dct_basis_1d_bf16`); every
    product is then exact and the sums stay fp32, here in index order (K1a's
    tensor cores sum the same products in their own order)."""
    if bf16:
        f = bf16_round(f)
    t = idct_columns_plain(f, a)
    if bf16:
        t = bf16_round(t)
    return idct_rows_plain(t, a)


def idct_block_naive(block_nat: np.ndarray) -> np.ndarray:
    """Direct-formula scalar IDCT of one natural-order [64] block (float32).

    Test-only parity twin of reference
    ``discrete_cosine_transform_inverse`` (``src/transform.rs:55-87``).
    """
    f = np.asarray(block_nat, dtype=np.float32).reshape(8, 8)
    out = np.zeros((8, 8), dtype=np.float32)
    alpha = np.ones(8, dtype=np.float32)
    alpha[0] = np.float32(1.0 / np.sqrt(2.0))
    for y in range(8):
        for x in range(8):
            s = np.float32(0.0)
            for v in range(8):
                for u in range(8):
                    s += (
                        alpha[u]
                        * alpha[v]
                        * f[v, u]
                        * np.float32(np.cos((2 * x + 1) * u * np.pi / 16))
                        * np.float32(np.cos((2 * y + 1) * v * np.pi / 16))
                    )
            out[y, x] = s / 4
    return out.reshape(64)


def dct_block_naive(pixels_nat: np.ndarray) -> np.ndarray:
    """Forward DCT of one [64] block — parity twin of the reference's unused
    forward transform (``src/transform.rs:18-53``), used by the encoder tests."""
    g = np.asarray(pixels_nat, dtype=np.float32).reshape(8, 8)
    out = np.zeros((8, 8), dtype=np.float32)
    alpha = np.ones(8, dtype=np.float32)
    alpha[0] = np.float32(1.0 / np.sqrt(2.0))
    for v in range(8):
        for u in range(8):
            s = np.float32(0.0)
            for y in range(8):
                for x in range(8):
                    s += (
                        g[y, x]
                        * np.float32(np.cos((2 * x + 1) * u * np.pi / 16))
                        * np.float32(np.cos((2 * y + 1) * v * np.pi / 16))
                    )
            out[v, u] = alpha[u] * alpha[v] * s / 4
    return out.reshape(64)


def forward_dct_matrix(dtype=np.float32) -> np.ndarray:
    """[64, 64] matrix: flat pixels (natural order) -> DCT coefficients
    (natural order): coeffs = pixels @ kron(A, A).T (used by the encoder)."""
    return _idct_kron().T.astype(dtype)
