"""The 1-D DCT basis the pixel kernel (K1) and its plain version use.

Copy of ``jpeg_tpu.ops.idct.dct_basis_1d``. The fused [64, 64] matrix of the
JAX compat pipeline is not part of the port's path: K1 runs the separable
8x8 IDCT with this basis in fp32.
"""

from __future__ import annotations

import numpy as np


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
