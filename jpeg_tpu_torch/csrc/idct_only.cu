// K5 and K6: bare dequant + 8x8 IDCT for Hopper (sm_90a), int16 plane in,
// fp32 plane out, one templated body for both.
//
// K5 replaces jpeg_tpu/ops/pallas_kernels.py::idct_only_kernel (the
// sandwich formulation, kron(I, A^T) @ F @ kron(I, A) on the MXU per
// [128, 256] cell); K6 replaces pallas_kernels.py::idct_only_kernel_roll
// (idct_roll_tile: 15 shift+mask terms per axis). Neither structure carries
// over: the kron matrices and the rolls exist because Mosaic has no
// reshapes.
//
// Exactness (built with --fmad=false): K5's twin (ops/idct_only.py::
// idct_only_plain) sums each pass's eight rounded products in ascending
// order from the first product. K6's twin adds 15 products per axis to a +0
// start; the seven masked ones are 0 x finite = +-0, which leave a sum that
// started at +0 unchanged (it never becomes -0), so K6 is the same eight
// terms from a +0 start: K5's values with -0 turned into +0
// (tests/test_torch_idct_only.py holds both models to the twins bit for
// bit). The IDCT is idct8x8.cuh's (shared with K1), and K6 differs from K5
// only in its template argument.
//
// Bound on the H100: device memory, 2 B in + 4 B out per pixel, 94.5 MB at
// [4096, 3840] (0.0282 ms at 3.35 TB/s). What the design does about it:
//   - bytes in flight: a thread owns one 8x8 block and issues its eight
//     16-byte row loads at once (128 B a thread); a warp takes 32 blocks
//     side by side, so each load instruction reads 512 contiguous bytes;
//   - the dequant pattern qpat [128, 256] (any values: the twin takes any)
//     is read as float4 at [(by & 15) * 8 + r][(bx & 31) * 8 + c], no
//     modulo; a thread block's warps take consecutive 8 x 256 strips, so
//     they share the pattern's rows in L1;
//   - both passes in registers (~1,500 fp32 instructions a block, ~0.011 ms
//     of issue over the plane);
//   - stores of whole lines: each row of a warp's strip goes out through
//     shared memory as 512 contiguous bytes an instruction; the plane's
//     loads and stores are streaming (__ldcs / __stcs), as neither is read
//     again. Measured against two float4 stores a row straight from
//     registers, and against both without the streaming hints, in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "idct8x8.cuh"

namespace {

constexpr int kCellRows = 128;  // the dequant pattern: one TPU grid cell
constexpr int kCellCols = 256;
constexpr int kWarps = 4;       // warps per thread block, one strip each
constexpr int kThreads = 32 * kWarps;

template <bool kZeroStart>
__global__ void __launch_bounds__(kThreads)
idct_only_kernel(const int16_t* __restrict__ x, const float* __restrict__ qpat,
                 const Basis bas, float* __restrict__ out, int cols) {
  // Warp w of the grid takes the strip of block row w / strips_x, block
  // columns (w % strips_x) * 32 .. + 31; lane l its block column + l.
  const int lane = threadIdx.x & 31;
  const int strips_x = cols / kCellCols;
  const int strip = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int by = strip / strips_x;
  const int bx = (strip - by * strips_x) * 32 + lane;
  const int64_t base = static_cast<int64_t>(by) * 8 * cols + bx * 8;
  const int16_t* src = x + base;
  int4 raw[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)  // read once: streaming, keep L1 for qpat
    raw[r] = __ldcs(reinterpret_cast<const int4*>(src + static_cast<int64_t>(r) * cols));
  // Pattern rows (by % 16) * 8 + r, columns (bx % 32) * 8 + c = lane * 8 + c.
  const float* q = qpat + (by & 15) * 8 * kCellCols + lane * 8;
  float f[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float4 q0 = __ldg(reinterpret_cast<const float4*>(q + r * kCellCols));
    const float4 q1 = __ldg(reinterpret_cast<const float4*>(q + r * kCellCols + 4));
    const float qs[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    const int w[4] = {raw[r].x, raw[r].y, raw[r].z, raw[r].w};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int16_t coef = static_cast<int16_t>(
          (c & 1) ? (w[c >> 1] >> 16) : (w[c >> 1] & 0xFFFF));
      f[r][c] = __fmul_rn(static_cast<float>(coef), qs[c]);
    }
  }
  idct8_columns(f, bas.a);
  // Each output row goes through a 1 KB shared row of the warp (two, used
  // in turn, so one __syncwarp a row suffices): lane l puts its block's
  // two float4 at l and 32 + ((l + 4) & 31) (free of bank conflicts for
  // both the writes and the reads below), then the warp stores the strip's
  // row as 64 float4, 512 contiguous bytes an instruction.
  __shared__ float4 stage[kWarps][2][64];
  float* dst = out + base - lane * 8;  // the strip's first column
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    float s[8];
    idct8_row<kZeroStart>(f[y], bas.a, s);
    float4* b = stage[threadIdx.x >> 5][y & 1];
    b[lane] = make_float4(s[0], s[1], s[2], s[3]);
    b[32 + ((lane + 4) & 31)] = make_float4(s[4], s[5], s[6], s[7]);
    __syncwarp();
    float4* row = reinterpret_cast<float4*>(dst + static_cast<int64_t>(y) * cols);
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // float4 t of the row: block t / 2, half t % 2
      const int t = lane + 32 * k, blk = t >> 1;
      __stcs(row + t, (t & 1) ? b[32 + ((blk + 4) & 31)] : b[blk]);
    }
  }
}

template <bool kZeroStart>
int launch(const void* x, const void* qpat, const float* basis, void* out,
           int32_t rows, int32_t cols, void* stream) {
  if (rows <= 0 || cols <= 0 || rows % kCellRows || cols % kCellCols ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(qpat) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Basis bas;
  for (int i = 0; i < 64; ++i) bas.a[i] = basis[i];
  // rows / 8 strips of cols / 256: a multiple of 16, so of kWarps.
  const int64_t strips = static_cast<int64_t>(rows / 8) * (cols / kCellCols);
  idct_only_kernel<kZeroStart>
      <<<static_cast<unsigned>(strips / kWarps), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int16_t*>(x), static_cast<const float*>(qpat), bas,
          static_cast<float*>(out), cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch K5 on `stream`: x int16 [rows, cols], qpat f32 [128, 256], out f32
// [rows, cols] (device pointers, 16-byte aligned, rows % 128 == cols % 256
// == 0); basis the host's 64 f32, A[u][x]. Returns cudaGetLastError() (0 =
// launched).
int jt_idct_only(const void* x, const void* qpat, const float* basis,
                 void* out, int32_t rows, int32_t cols, void* stream) {
  return launch<false>(x, qpat, basis, out, rows, cols, stream);
}

// Launch K6 on `stream`; the same arguments as jt_idct_only.
int jt_idct_only_roll(const void* x, const void* qpat, const float* basis,
                      void* out, int32_t rows, int32_t cols, void* stream) {
  return launch<true>(x, qpat, basis, out, rows, cols, stream);
}

}  // extern "C"
