// K2: fused forward transform (the encoder's dense half) for Hopper (sm_90a).
//
// Replaces the Pallas kernel jpeg_tpu/ops/pallas_kernels.py::_encode_kernel
// (built by fused_plane_encoder). Same function: edge-padded planar RGB (or
// gray) u8 -> YCbCr level-shifted fp32, chroma box mean, 8x8 forward DCT,
// multiply by the reciprocal quant table, round half to even, clamp to
// +-32767, int16 coefficient planes in the padded layout the C++ entropy
// encoder reads (ops/fused_plane.py::padded_plane_shapes). Not the same
// structure: the TPU kernel's block-diagonal kron matrices, box-mean
// matrices and tiled reciprocal patterns exist only because Mosaic has no
// reshapes. Here each thread block owns one (image, 128-row band,
// 256-column tile) cell, as K1 does, and walks the band one MCU row at a
// time through shared memory:
//   1. a thread per component sample reads its fy x fx RGB pixels, converts
//      each to the component's value and box-averages them by index (rows
//      first, then columns) into shared memory;
//   2. vertical 1-D DCT pass in place, a thread per (8x8 block, column);
//   3. horizontal pass, a thread per (row, 8x8 block): eight coefficients,
//      quantised and stored as one 16-byte write.
//
// Exactness: fp32 throughout with the dct_basis_1d basis, in the order the
// JAX kernel runs on the CPU, where XLA contracts multiply-adds: the colour
// rows as fma(k0, r, k1 * g) then fma(k2, b, .), and each DCT sum as its
// first product followed by one fma per term in index order. Every
// operation is an explicit intrinsic (__fmul_rn / __fadd_rn / __fmaf_rn)
// and the library is built with --fmad=false, so nvcc adds no contraction
// of its own and the plain PyTorch twin
// (ops/fused_encode.py::fused_plane_encode_plain, which emulates the fma
// exactly) computes the same values. Rounding is rintf (half to even, as
// jnp.round), never roundf. No TF32, no tensor cores.
//
// Bound on the H100: memory. Per pixel of 4:2:0 the kernel reads 3 bytes of
// u8 and writes 3 bytes of int16 coefficients, against ~40 fp32 flops: far
// below the card's ~20 flop/byte ridge for fp32 on CUDA cores. Nothing is
// staged in device memory between the colour stage and the quantiser.
// Each component re-reads its RGB pixels (from L1/L2); TMA loads and wider
// input reads are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 256;    // Y-resolution columns per block
constexpr int kThreads = 256;
constexpr int kMaxComp = 3;

struct Planes {
  int16_t* ptr[kMaxComp];
  int64_t rows[kMaxComp];
  int64_t stride[kMaxComp];
  int h[kMaxComp];
  int v[kMaxComp];
};

// Component c of the pixel at offset o of one image's planar input
// (pallas_kernels.py:427-434), contracted as XLA's CPU code contracts it.
__device__ __forceinline__ float component(const uint8_t* __restrict__ img,
                                           int64_t o, int64_t plane_sz,
                                           int c, int n_comp) {
  const float r = static_cast<float>(img[o]);
  if (n_comp == 1) return __fsub_rn(r, 128.0f);
  const float g = static_cast<float>(img[o + plane_sz]);
  const float b = static_cast<float>(img[o + 2 * plane_sz]);
  if (c == 0)
    return __fsub_rn(
        __fmaf_rn(0.114f, b, __fmaf_rn(0.299f, r, __fmul_rn(0.587f, g))),
        128.0f);
  if (c == 1)
    return __fmaf_rn(0.5f, b,
                     __fmaf_rn(-0.168735892f, r, __fmul_rn(-0.331264108f, g)));
  return __fmaf_rn(-0.081312411f, b,
                   __fmaf_rn(0.5f, r, __fmul_rn(-0.418687589f, g)));
}

__global__ void __launch_bounds__(kThreads)
fused_encode_kernel(const uint8_t* __restrict__ rgb,  // [B, n_comp, h_pad, w_pad]
                    Planes pl, int n_comp, int h_max, int v_max, int band_mcus,
                    const float* __restrict__ iqtab,  // [B, n_comp, 64]
                    const float* __restrict__ basis,  // [8, 8] A[u][x]
                    int64_t h_pad, int64_t w_pad) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_a[64];
  __shared__ float s_iq[kMaxComp * 64];
  const int tile = blockIdx.x;
  const int band = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x;

  if (tid < 64) s_a[tid] = basis[tid];
  if (tid < n_comp * 64) s_iq[tid] = iqtab[b * n_comp * 64 + tid];

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

  const int64_t plane_sz = h_pad * w_pad;
  const uint8_t* img = rgb + b * n_comp * plane_sz;

  for (int m = 0; m < band_mcus; ++m) {
    const int64_t mcu_row = static_cast<int64_t>(band) * band_mcus + m;

    // 1. Colour + box mean: row mean r[X] = sum_dy p[Y0+dy][X] * (1/fy),
    //    then sum_dx r[X0+dx] * (1/fx), both in ascending order.
    for (int c = 0; c < n_comp; ++c) {
      const int n_items = 8 * pl.v[c] * cols[c];
      const float inv_fy = 1.0f / fy[c];
      const float inv_fx = 1.0f / fx[c];
      for (int it = tid; it < n_items; it += kThreads) {
        const int r = it / cols[c];
        const int j = it - r * cols[c];
        const int64_t y0 = (mcu_row * 8 * pl.v[c] + r) * fy[c];
        const int64_t x0 = static_cast<int64_t>(tile) * kTileW + j * fx[c];
        float acc = 0.0f;
        for (int dx = 0; dx < fx[c]; ++dx) {
          float col = component(img, y0 * w_pad + x0 + dx, plane_sz, c, n_comp);
          if (fy[c] > 1) {
            col = __fmul_rn(col, inv_fy);
            for (int dy = 1; dy < fy[c]; ++dy)
              col = __fadd_rn(col, __fmul_rn(
                  component(img, (y0 + dy) * w_pad + x0 + dx, plane_sz, c,
                            n_comp),
                  inv_fy));
          }
          if (fx[c] > 1) {
            col = __fmul_rn(col, inv_fx);
            acc = dx == 0 ? col : __fadd_rn(acc, col);
          } else {
            acc = col;
          }
        }
        buf[c][r * cols[c] + j] = acc;
      }
    }
    __syncthreads();

    // 2. Vertical pass in place: t[u][x] = sum_y A[u][y] * g[y][x].
    for (int c = 0; c < n_comp; ++c) {
      const int n_items = pl.v[c] * cols[c];  // (block row, column) pairs
      for (int it = tid; it < n_items; it += kThreads) {
        const int by = it / cols[c];
        const int j = it - by * cols[c];
        float* colp = buf[c] + by * 8 * cols[c] + j;
        float g[8];
#pragma unroll
        for (int y = 0; y < 8; ++y) g[y] = colp[y * cols[c]];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          float acc = __fmul_rn(s_a[u * 8], g[0]);
#pragma unroll
          for (int y = 1; y < 8; ++y) acc = __fmaf_rn(s_a[u * 8 + y], g[y], acc);
          colp[u * cols[c]] = acc;
        }
      }
    }
    __syncthreads();

    // 3. Horizontal pass c[u][v] = sum_x t[u][x] * A[v][x], quantise, store.
    for (int c = 0; c < n_comp; ++c) {
      const int nbx = cols[c] / 8;
      const int n_items = 8 * pl.v[c] * nbx;  // (row, block column) pairs
      int16_t* plane = pl.ptr[c] + b * pl.rows[c] * pl.stride[c];
      for (int it = tid; it < n_items; it += kThreads) {
        const int r = it / nbx;
        const int bx = it - r * nbx;
        const int u = r & 7;
        const float4* src =
            reinterpret_cast<const float4*>(buf[c] + r * cols[c] + bx * 8);
        const float4 lo = src[0], hi = src[1];
        const float t[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        __align__(16) int16_t q[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          float acc = __fmul_rn(t[0], s_a[v * 8]);
#pragma unroll
          for (int x = 1; x < 8; ++x) acc = __fmaf_rn(t[x], s_a[v * 8 + x], acc);
          float z = rintf(__fmul_rn(acc, s_iq[c * 64 + u * 8 + v]));
          z = fminf(fmaxf(z, -32767.0f), 32767.0f);
          q[v] = static_cast<int16_t>(static_cast<int>(z));
        }
        const int64_t row = mcu_row * 8 * pl.v[c] + r;
        const int64_t col = static_cast<int64_t>(tile) * cols[c] + bx * 8;
        *reinterpret_cast<uint4*>(plane + row * pl.stride[c] + col) =
            *reinterpret_cast<const uint4*>(q);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launch K2 on `stream`. Device pointers: rgb ([batch, n_comp, h_pad, w_pad]
// u8, contiguous), planes[c] ([batch, h_pad * v[c] / v_max, stride[c]] int16,
// contiguous, 16-byte aligned), iqtab ([batch, n_comp, 64] f32), basis
// ([64] f32). Host arrays: planes, stride, h, v (n_comp entries each).
// Returns cudaGetLastError() after the launch (0 = launched).
int jt_fused_encode(const void* rgb, void* const* planes, const int64_t* stride,
                    const int32_t* h, const int32_t* v, int32_t n_comp,
                    int32_t h_max, int32_t v_max, int32_t band_mcus,
                    int32_t n_bands, const void* iqtab, const void* basis,
                    int64_t batch, int64_t h_pad, int64_t w_pad, void* stream) {
  if (n_comp < 1 || n_comp > kMaxComp || w_pad % kTileW != 0 ||
      h_pad != static_cast<int64_t>(n_bands) * band_mcus * 8 * v_max ||
      batch < 1 || batch > 65535 || n_bands < 1 || n_bands > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Planes pl{};
  size_t smem = 0;
  for (int c = 0; c < n_comp; ++c) {
    if (h[c] < 1 || v[c] < 1 || h_max % h[c] != 0 || v_max % v[c] != 0 ||
        (kTileW / (h_max / h[c])) % 64 != 0 ||
        reinterpret_cast<uintptr_t>(planes[c]) % 16 != 0 ||
        stride[c] % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    pl.ptr[c] = static_cast<int16_t*>(planes[c]);
    pl.rows[c] = h_pad * v[c] / v_max;
    pl.stride[c] = stride[c];
    pl.h[c] = h[c];
    pl.v[c] = v[c];
    smem += sizeof(float) * 8 * v[c] * (kTileW / (h_max / h[c]));
  }
  // Up to 3 x 32 x 256 floats (96 KB) with 4x4 sampling: opt in past 48 KB.
  cudaError_t e = cudaFuncSetAttribute(
      fused_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>(w_pad / kTileW),
            static_cast<unsigned>(n_bands), static_cast<unsigned>(batch));
  fused_encode_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), pl, n_comp, h_max, v_max, band_mcus,
      static_cast<const float*>(iqtab), static_cast<const float*>(basis),
      h_pad, w_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
