// The 8x8 inverse DCT of one dequantised block held in a thread's registers,
// shared by K1 (fused_plane.cu) and K5/K6 (idct_only.cu). Both libraries are
// built with --fmad=false.
//
// Exactness: every product and every sum rounded on its own (__fmul_rn /
// __fadd_rn), each sum in ascending index order, vertical pass first, as
// the plain twins compute them (ops/idct.py::idct_blocks_plain). The float32
// basis is mirror-symmetric bit for bit, A[v][7-y] = (-1)^v A[v][y]
// (tests/test_torch_fused_plane.py checks it), so each rounded product also
// serves output 7-y, negated for odd v: the twin's terms in the twin's
// order, with half the products (~1,500 fp32 instructions a block).
// K1a, the bf16 tier, does not use it: its IDCT runs on the tensor cores,
// two blocks per mma.sync pair (fused_plane.cu, idct_stage_mma).

#pragma once

#include <cuda_runtime.h>

// The 1-D basis A[u][x], row-major, passed by value as a kernel argument:
// its reads come from the constant bank.
struct Basis {
  float a[64];
};

// Vertical pass in place: f[y][u] <- sum_v A[v][y] * f[v][u], v ascending,
// from the v = 0 product.
__device__ __forceinline__ void idct8_columns(float (&f)[8][8], const float* a) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float col[8];
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const float p0 = __fmul_rn(a[y], f[0][u]);
      float lo = p0, hi = p0;
#pragma unroll
      for (int v = 1; v < 8; ++v) {
        const float p = __fmul_rn(a[v * 8 + y], f[v][u]);
        lo = __fadd_rn(lo, p);
        hi = __fadd_rn(hi, (v & 1) ? -p : p);
      }
      col[y] = lo;
      col[7 - y] = hi;
    }
#pragma unroll
    for (int y = 0; y < 8; ++y) f[y][u] = col[y];
  }
}

// Horizontal pass of one row: s[x] = sum_u t[u] * A[u][x], u ascending.
// kZeroStart sums from +0.0f (K6's twin, whose masked terms add zeros to a
// +0 start), otherwise from the u = 0 product (K1's and K5's twins). The two
// differ only in the sign of a zero result, so the vertical pass, whose
// zeros' signs this pass erases under a +0 start, needs no such variant.
template <bool kZeroStart>
__device__ __forceinline__ void idct8_row(const float (&t)[8], const float* a,
                                          float (&s)[8]) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float p0 = __fmul_rn(t[0], a[x]);
    float lo = kZeroStart ? __fadd_rn(0.0f, p0) : p0;
    float hi = lo;
#pragma unroll
    for (int u = 1; u < 8; ++u) {
      const float p = __fmul_rn(t[u], a[u * 8 + x]);
      lo = __fadd_rn(lo, p);
      hi = __fadd_rn(hi, (u & 1) ? -p : p);
    }
    s[x] = lo;
    s[7 - x] = hi;
  }
}
