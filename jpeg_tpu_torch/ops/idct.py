"""The 1-D DCT basis the pixel kernel (K1), the forward kernel (K2), the bare
IDCT kernel (K5) and their plain versions use, and the host encoder's
forward DCT matrix.

Copies of ``jpeg_tpu.ops.idct.dct_basis_1d`` and ``forward_dct_matrix``. The
fused [64, 64] dequant matrix of the JAX compat pipeline is not part of the
port's path: K1, K2 and K5 run the separable 8x8 transform with this basis
in fp32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


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


@lru_cache(maxsize=None)
def _idct_kron() -> np.ndarray:
    """kron(A, A): [64, 64] so that out_flat = F_flat(natural) @ K."""
    a = dct_basis_1d()
    return np.kron(a, a)


def idct_blocks_plain(f: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Separable 8x8 IDCT of dequantised blocks ``f [..., R, 8, C, 8]``
    (block row, v, block column, u) with the basis ``a [8, 8]``, both fp32.
    Eight terms summed in index order with each product rounded, as K1 and
    K5 do: vertical pass first, t[y][u] = sum_v A[v][y] F[v][u], then
    s[y][x] = sum_u t[y][u] A[u][x]."""
    t = a[0].view(8, 1, 1) * f[..., 0:1, :, :]
    for k in range(1, 8):
        t = t + a[k].view(8, 1, 1) * f[..., k:k + 1, :, :]
    s = t[..., 0:1] * a[0]
    for k in range(1, 8):
        s = s + t[..., k:k + 1] * a[k]
    return s


def forward_dct_matrix(dtype=np.float32) -> np.ndarray:
    """[64, 64] matrix: flat pixels (natural order) -> DCT coefficients
    (natural order): coeffs = pixels @ kron(A, A).T (used by the encoder)."""
    return _idct_kron().T.astype(dtype)
