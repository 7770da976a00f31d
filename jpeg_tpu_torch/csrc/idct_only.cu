// K5 and K6: bare dequant + 8x8 IDCT for Hopper (sm_90a), int16 plane in,
// fp32 plane out. Built with --fmad=false: every product is rounded on its
// own (__fmul_rn / __fadd_rn), in the order of the plain PyTorch twins of
// jpeg_tpu_torch/ops/idct_only.py, so each kernel matches its twin bit for
// bit.
//
// K5 replaces jpeg_tpu/ops/pallas_kernels.py::idct_only_kernel, the sandwich
// formulation: kron(I, A^T) @ F @ kron(I, A) on the MXU, per [128, 256]
// cell. Here a block of 64 x 8 threads stages an 8 x 64 tile of dequantised
// coefficients in shared memory, and a thread per output pixel does the
// 8-term column product, then (after a barrier) the 8-term row product,
// against the basis in constant memory. No kron matrices: 16 products per
// pixel instead of the sandwich's 384. The row product reads a shared copy
// of the basis: its lanes differ in x, and constant memory serialises a
// warp's distinct addresses (read from constant memory there, the kernel
// took 0.29 ms at [4096, 3840] on the H100, K6 0.08 ms).
//
// K6 replaces pallas_kernels.py::idct_only_kernel_roll (idct_roll_tile):
// 15 shift+mask passes per axis. A thread holds one column of an 8-row block
// strip in registers; the row pass shifts within those registers, the column
// pass exchanges values by __shfl_sync within 8-lane groups (the TPU's lane
// rotate), with the masks of roll_masks in constant memory. A wrapped term
// meets a zero mask, as on the TPU, so it adds an exact zero.
//
// Bound on the H100: device memory, 2 B in + 4 B out per pixel (the dequant
// pattern, 128 KB, stays in L2). Both kernels read and write each row of a
// tile as contiguous 128-byte / 256-byte runs (K5) or 512 B / 1 KB (K6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCellRows = 128;  // the dequant pattern: one TPU grid cell
constexpr int kCellCols = 256;
constexpr int kTileCols = 64;   // K5: a block's tile is 8 x kTileCols
constexpr int kRollCols = 256;  // K6: a block's strip is 8 x kRollCols

__constant__ float c_basis[64];       // A[u][x]
__constant__ float c_mrow[8 * 15];    // [x][d + 7]: A[x + d][x] or 0
__constant__ float c_mcol[15 * 8];    // [d + 7][x]: the same by columns

__device__ __forceinline__ float dequant(const int16_t* x, const float* qpat,
                                         int64_t row, int64_t col,
                                         int cols) {
  return __fmul_rn(static_cast<float>(x[row * cols + col]),
                   qpat[(row % kCellRows) * kCellCols + col % kCellCols]);
}

__global__ void __launch_bounds__(kTileCols * 8)
idct_only_kernel(const int16_t* __restrict__ x, const float* __restrict__ qpat,
                 float* __restrict__ out, int cols) {
  __shared__ float f[8][kTileCols];
  __shared__ float t[8][kTileCols];
  __shared__ float basis[64];  // for the row product, whose lanes differ in x
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * 8 + ty;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTileCols + tx;
  if (ty == 0) basis[tx] = c_basis[tx];  // kTileCols == 64
  f[ty][tx] = dequant(x, qpat, row, col, cols);
  __syncthreads();
  // Column product: t[y][u] = sum_v A[v][y] * F[v][u], v ascending.
  float acc = __fmul_rn(c_basis[ty], f[0][tx]);
#pragma unroll
  for (int v = 1; v < 8; ++v)
    acc = __fadd_rn(acc, __fmul_rn(c_basis[v * 8 + ty], f[v][tx]));
  t[ty][tx] = acc;
  __syncthreads();
  // Row product: s[y][x] = sum_u t[y][u] * A[u][x], u ascending.
  const int b0 = tx & ~7, xx = tx & 7;
  float s = __fmul_rn(t[ty][b0], basis[xx]);
#pragma unroll
  for (int u = 1; u < 8; ++u)
    s = __fadd_rn(s, __fmul_rn(t[ty][b0 + u], basis[u * 8 + xx]));
  out[row * cols + col] = s;
}

__global__ void __launch_bounds__(kRollCols)
idct_only_roll_kernel(const int16_t* __restrict__ x,
                      const float* __restrict__ qpat, float* __restrict__ out,
                      int cols) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kRollCols + threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * 8;
  float f[8], acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = dequant(x, qpat, row0 + i, col, cols);
  // Row pass: acc[i] = sum_d mrow[i][d] * f[i + d], d = -7..7 ascending.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int d = -7; d <= 7; ++d)
      s = __fadd_rn(s, __fmul_rn(c_mrow[i * 15 + d + 7], f[(i + d) & 7]));
    acc[i] = s;
  }
  // Column pass: out[i] at column c = sum_d mcol[d][c % 8] * acc[i] at
  // column c + d, fetched from the neighbouring lane of the 8-lane group.
  const int lane = threadIdx.x & 31;
  const int group = lane & ~7, xx = lane & 7;
  float m[15];
#pragma unroll
  for (int d = 0; d < 15; ++d) m[d] = c_mcol[d * 8 + xx];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int d = -7; d <= 7; ++d) {
      const float v = __shfl_sync(0xffffffffu, acc[i], group | ((xx + d) & 7));
      s = __fadd_rn(s, __fmul_rn(m[d + 7], v));
    }
    out[(row0 + i) * cols + col] = s;
  }
}

bool bad_shape(int rows, int cols) {
  return rows <= 0 || cols <= 0 || rows % kCellRows || cols % kCellCols;
}

}  // namespace

extern "C" {

// Copy the basis A [8][8] and the period-8 masks mrow [8][15], mcol [15][8]
// (host pointers) into this device's constant memory. Returns the CUDA error.
int jt_idct_only_tables(const float* basis, const float* mrow,
                        const float* mcol) {
  cudaError_t e = cudaMemcpyToSymbol(c_basis, basis, sizeof(c_basis));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_mrow, mrow, sizeof(c_mrow));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_mcol, mcol, sizeof(c_mcol));
  return static_cast<int>(e);
}

// Launch K5 on `stream`: x int16 [rows, cols], qpat f32 [128, 256], out f32
// [rows, cols], device pointers. Returns cudaGetLastError() (0 = launched).
int jt_idct_only(const void* x, const void* qpat, void* out, int32_t rows,
                 int32_t cols, void* stream) {
  if (bad_shape(rows, cols)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cols / kTileCols, rows / 8), block(kTileCols, 8);
  idct_only_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), static_cast<const float*>(qpat),
      static_cast<float*>(out), cols);
  return static_cast<int>(cudaGetLastError());
}

// Launch K6 on `stream`; the same arguments as jt_idct_only.
int jt_idct_only_roll(const void* x, const void* qpat, void* out, int32_t rows,
                      int32_t cols, void* stream) {
  if (bad_shape(rows, cols)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cols / kRollCols, rows / 8);
  idct_only_roll_kernel<<<grid, kRollCols, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), static_cast<const float*>(qpat),
      static_cast<float*>(out), cols);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
