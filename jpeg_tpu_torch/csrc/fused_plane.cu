// K1: fused coefficient-plane -> RGB u8 pixel kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel jpeg_tpu/ops/pallas_kernels.py::_plane_kernel
// (built by fused_plane_decoder). Same function: dequantise int16
// natural-order coefficient planes, 8x8 inverse DCT, replicate-upsample
// chroma, YCbCr->RGB in the reference's operation order, +128, truncate or
// round, clamp, u8. Not the same structure: the TPU kernel's block-diagonal
// kron matrices, 128-column splits and tiled quant patterns exist only
// because Mosaic has no reshapes. Here each thread block owns one
// (image, 128-row band, 256-column tile) cell of the C++ runtime's padded
// plane layout and walks the band one MCU row at a time:
//   1. vertical 1-D IDCT pass: a thread per (8x8 block, column) loads eight
//      int16 coefficients (coalesced across the column tile), dequantises
//      with the image's 64-entry natural-order table held in shared memory,
//      and writes eight fp32 values to shared memory;
//   2. horizontal pass in place, a thread per (row, 8x8 block);
//   3. a thread per Y-resolution pixel gathers each component by index
//      (y / fy, x / fx), converts colour and writes planar u8.
//
// Exactness: fp32 throughout with the dct_basis_1d basis, every product and
// sum rounded separately (__fmul_rn / __fadd_rn, and the library is built
// with --fmad=false) and summed in index order, so the plain PyTorch twin
// (ops/fused_plane.py::fused_plane_decode_plain) computes the same values.
// No TF32, no tensor cores.
//
// Bound on the H100: memory. Per output pixel of 4:2:0 the kernel reads
// 3 bytes of int16 coefficients and writes 3 bytes of u8, against ~30 fp32
// flops: far below the card's ~20 flop/byte ridge for fp32 on CUDA cores.
// Nothing is staged in device memory between the IDCT and the colour
// stage; that fusion is what the design buys. Making the loads and stores
// wider (and the shared-memory row pass conflict-free) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 256;    // Y-resolution columns per block
constexpr int kThreads = 256;
constexpr int kMaxComp = 3;

struct Planes {
  const int16_t* ptr[kMaxComp];
  int64_t rows[kMaxComp];
  int64_t stride[kMaxComp];
  int h[kMaxComp];
  int v[kMaxComp];
};

__device__ __forceinline__ uint8_t to_u8(float x, int round_mode) {
  if (round_mode) x = floorf(__fadd_rn(x, 0.5f));
  x = fminf(fmaxf(x, 0.0f), 255.0f);
  return static_cast<uint8_t>(static_cast<int>(x));
}

__global__ void __launch_bounds__(kThreads)
fused_plane_kernel(Planes pl, int n_comp, int h_max, int v_max, int band_mcus,
                   const float* __restrict__ qtab,   // [B, n_comp, 64]
                   const float* __restrict__ basis,  // [8, 8] A[u][x]
                   uint8_t* __restrict__ out,        // [B, 3, h_pad, w_pad]
                   int64_t h_pad, int64_t w_pad, int round_mode) {
  extern __shared__ float smem[];
  __shared__ float s_a[64];
  __shared__ float s_q[kMaxComp * 64];
  const int tile = blockIdx.x;
  const int band = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x;

  if (tid < 64) s_a[tid] = basis[tid];
  if (tid < n_comp * 64) s_q[tid] = qtab[b * n_comp * 64 + tid];

  // Shared buffer of component c: [8 * v_c rows, kTileW / fx_c columns].
  float* buf[kMaxComp];
  int cols[kMaxComp], fx[kMaxComp], fy[kMaxComp];
  int off = 0;
  for (int c = 0; c < n_comp; ++c) {
    fx[c] = h_max / pl.h[c];
    fy[c] = v_max / pl.v[c];
    cols[c] = kTileW / fx[c];
    buf[c] = smem + off;
    off += 8 * pl.v[c] * cols[c];
  }
  __syncthreads();

  for (int m = 0; m < band_mcus; ++m) {
    const int64_t mcu_row = static_cast<int64_t>(band) * band_mcus + m;

    // 1. Dequantise + vertical pass: t[y][u] = sum_v A[v][y] * F[v][u].
    for (int c = 0; c < n_comp; ++c) {
      const int n_items = pl.v[c] * cols[c];  // (block row, column) pairs
      const int16_t* plane = pl.ptr[c] + b * pl.rows[c] * pl.stride[c];
      for (int it = tid; it < n_items; it += kThreads) {
        const int by = it / cols[c];
        const int col = it - by * cols[c];
        const int u = col & 7;
        const int64_t row0 = mcu_row * 8 * pl.v[c] + by * 8;
        const int64_t gcol = static_cast<int64_t>(tile) * cols[c] + col;
        float f[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const float coef = static_cast<float>(
              plane[(row0 + v) * pl.stride[c] + gcol]);
          f[v] = __fmul_rn(coef, s_q[c * 64 + v * 8 + u]);
        }
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          float acc = 0.0f;
#pragma unroll
          for (int v = 0; v < 8; ++v)
            acc = __fadd_rn(acc, __fmul_rn(s_a[v * 8 + y], f[v]));
          buf[c][(by * 8 + y) * cols[c] + col] = acc;
        }
      }
    }
    __syncthreads();

    // 2. Horizontal pass in place: s[y][x] = sum_u t[y][u] * A[u][x].
    for (int c = 0; c < n_comp; ++c) {
      const int nbx = cols[c] / 8;
      const int n_items = 8 * pl.v[c] * nbx;  // (row, block column) pairs
      for (int it = tid; it < n_items; it += kThreads) {
        const int r = it / nbx;
        const int bx = it - r * nbx;
        float* row = buf[c] + r * cols[c] + bx * 8;
        float t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) t[u] = row[u];
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          float acc = 0.0f;
#pragma unroll
          for (int u = 0; u < 8; ++u)
            acc = __fadd_rn(acc, __fmul_rn(t[u], s_a[u * 8 + x]));
          row[x] = acc;
        }
      }
    }
    __syncthreads();

    // 3. Upsample by index, colour convert, write planar u8.
    const int rows_y = 8 * v_max;
    const int64_t plane_sz = h_pad * w_pad;
    for (int it = tid; it < rows_y * kTileW; it += kThreads) {
      const int yy = it / kTileW;
      const int xx = it - yy * kTileW;
      const int64_t o = (b * 3) * plane_sz +
                        (mcu_row * rows_y + yy) * w_pad +
                        static_cast<int64_t>(tile) * kTileW + xx;
      const float y = buf[0][(yy / fy[0]) * cols[0] + xx / fx[0]];
      if (n_comp == 1) {
        const uint8_t g = to_u8(__fadd_rn(y, 128.0f), round_mode);
        out[o] = g;
        out[o + plane_sz] = g;
        out[o + 2 * plane_sz] = g;
      } else {
        const float cb = buf[1][(yy / fy[1]) * cols[1] + xx / fx[1]];
        const float cr = buf[2][(yy / fy[2]) * cols[2] + xx / fx[2]];
        // Reference order (src/jpeg/decoder.rs:392-402), float32 constants
        // as the JAX package rounds them.
        const float kr = static_cast<float>(2.0 - 2.0 * 0.299);
        const float kb = static_cast<float>(2.0 - 2.0 * 0.114);
        const float r = __fadd_rn(__fmul_rn(cr, kr), y);
        const float bl = __fadd_rn(__fmul_rn(cb, kb), y);
        const float g = __fdiv_rn(
            __fsub_rn(__fsub_rn(y, __fmul_rn(0.114f, bl)),
                      __fmul_rn(0.299f, r)),
            0.587f);
        out[o] = to_u8(__fadd_rn(r, 128.0f), round_mode);
        out[o + plane_sz] = to_u8(__fadd_rn(g, 128.0f), round_mode);
        out[o + 2 * plane_sz] = to_u8(__fadd_rn(bl, 128.0f), round_mode);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launch K1 on `stream`. Device pointers: planes[c] ([batch, rows[c],
// stride[c]] int16, contiguous), qtab ([batch, n_comp, 64] f32), basis
// ([64] f32), out ([batch, 3, h_pad, w_pad] u8). Host arrays: planes, rows,
// stride, h, v (n_comp entries each). Returns cudaGetLastError() after the
// launch (0 = launched).
int jt_fused_plane_decode(const void* const* planes, const int64_t* rows,
                          const int64_t* stride, const int32_t* h,
                          const int32_t* v, int32_t n_comp, int32_t h_max,
                          int32_t v_max, int32_t band_mcus, int32_t n_bands,
                          const void* qtab, const void* basis, void* out,
                          int64_t batch, int64_t h_pad, int64_t w_pad,
                          int32_t round_mode, void* stream) {
  if (n_comp < 1 || n_comp > kMaxComp || w_pad % kTileW != 0 ||
      batch < 1 || batch > 65535 || n_bands < 1 || n_bands > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Planes pl{};
  size_t smem = 0;
  for (int c = 0; c < n_comp; ++c) {
    pl.ptr[c] = static_cast<const int16_t*>(planes[c]);
    pl.rows[c] = rows[c];
    pl.stride[c] = stride[c];
    pl.h[c] = h[c];
    pl.v[c] = v[c];
    smem += sizeof(float) * 8 * v[c] * (kTileW / (h_max / h[c]));
  }
  // Up to 3 x 32 x 256 floats (96 KB) with 4x4 sampling: opt in past 48 KB.
  cudaError_t e = cudaFuncSetAttribute(
      fused_plane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>(w_pad / kTileW),
            static_cast<unsigned>(n_bands), static_cast<unsigned>(batch));
  fused_plane_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      pl, n_comp, h_max, v_max, band_mcus, static_cast<const float*>(qtab),
      static_cast<const float*>(basis), static_cast<uint8_t*>(out), h_pad,
      w_pad, round_mode);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
