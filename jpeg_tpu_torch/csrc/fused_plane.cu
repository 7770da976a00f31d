// K1: fused coefficient-plane -> RGB u8 pixel kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel jpeg_tpu/ops/pallas_kernels.py::_plane_kernel
// (built by fused_plane_decoder). Same function: dequantise int16
// natural-order coefficient planes, 8x8 inverse DCT, replicate-upsample
// chroma, YCbCr->RGB in the reference's operation order, +128, truncate or
// round, clamp, u8. Not the same structure: the TPU kernel's block-diagonal
// kron matrices, 128-column splits and tiled quant patterns exist only
// because Mosaic has no reshapes. Here each thread block owns one cell of
// the C++ runtime's padded plane layout: one MCU row of one image by one
// 256-column tile (at 4:2:0, 64 Y and 32 chroma blocks, 4,096 pixels).
// Cells share nothing, so several are in flight on each SM.
//   1. One thread per 8x8 block: eight 16-byte loads, one block row each
//      (neighbouring threads take neighbouring blocks, so a warp reads 512
//      contiguous bytes per load), dequantise with the image's natural-order
//      table (shared memory), vertical then horizontal 1-D pass in
//      registers, eight rows of eight floats into shared memory as 16-byte
//      chunks. The chunk index is swizzled (c ^ ((c >> 3) & 3) within a
//      row) so these writes and the colour stage's reads are free of bank
//      conflicts.
//   2. One thread per 16 output pixels of a row, four at a time: each
//      component's values by index (y / fy, x / fx) as 16-byte chunks,
//      colour conversion, and 16 u8 per plane packed into one 16-byte store
//      per plane.
//
// Exactness: fp32 throughout with the dct_basis_1d basis, every product and
// sum rounded separately (__fmul_rn / __fadd_rn, and the library is built
// with --fmad=false) and summed in index order, so the plain PyTorch twin
// (ops/fused_plane.py::fused_plane_decode_plain) computes the same values.
// No TF32, no tensor cores. The IDCT is idct8x8.cuh's, shared with K5 and
// K6; its basis is a kernel argument (constant bank). The colour stage's division by 0.587 and
// its u8 conversion take shorter routes that give the same bits (see
// divide_green and to_u8).
//
// Bound on the H100: bytes, 0.120 ms for 8 4K frames (3 bytes of int16 in
// and 3 of u8 out per 4:2:0 pixel at 3.35 TB/s). It takes 2-3x that: the
// fp32 work, every product and sum rounded apart (no FMA), is ~1,500
// instructions a block and ~30 a pixel, and the loads, the shared-memory
// traffic and the stores, the IDCT's arithmetic and the colour stage's each
// take a comparable share of the time.
//
// K1a, the approx tier (template flag kApprox): the same kernel with the
// TPU kernel's idct_mode="approx" arithmetic. There the two IDCT products
// run at Precision.DEFAULT, one bf16 pass (pallas_kernels.py:301,
// sandwich_idct_split :160-185): the dequantised block and the basis are
// rounded to bf16, the vertical pass sums in fp32, its result is rounded to
// bf16, and the horizontal pass sums in fp32 (idct8x8.cuh,
// idct8_columns_bf16 / idct8_row_bf16; the launcher's caller passes the
// bf16-rounded basis). The plain twin rounds at the same places and sums in
// the same order, so the two are bit-equal. Products of bf16 values are
// exact, so K1a's IDCT takes one fma a term where K1 takes a product and
// two sums a mirrored pair: fewer instructions, plus two roundings per
// coefficient. Same byte bound as K1. The tier exists to be cheaper on a
// matrix unit: mma.sync / wgmma over blocks packed into tiles is the next
// kernel's design.

#include <cuda_runtime.h>
#include <stdint.h>

#include "idct8x8.cuh"

namespace {

constexpr int kTileW = 256;  // Y-resolution columns per cell
constexpr int kThreads = 128;
constexpr int kMaxComp = 3;

// Per component: its plane and where its blocks sit in a cell.
struct Comp {
  const int16_t* ptr;  // [B, rows, stride]
  int64_t rows, stride;
  int v;      // block rows per cell
  int nbx;    // block columns per cell (8, 16 or 32)
  int nbx_log2;
  int fx_log2, fy_log2;  // upsampling factors 1, 2, 4
  int first;  // index of its first block in the cell
  int tile;   // float offset of its pixels in the tile
};

struct Geometry {
  Comp c[kMaxComp];
  int n_comp, v_max, n_blocks;
};

// The component of block `blk` of a cell.
__device__ __forceinline__ int comp_of(const Geometry& g, int blk) {
  return blk < g.c[1].first || g.n_comp == 1 ? 0 : (blk < g.c[2].first ? 1 : 2);
}

// Float offset of 16-byte chunk `c` of a shared-memory pixel row (swizzled).
__device__ __forceinline__ int chunk_at(int c) { return (c ^ ((c >> 3) & 3)) * 4; }

// x / 0.587f rounded to nearest, for x = 0 and kDivLo <= |x| <= kDivHi:
// the quotient of x and the rounded reciprocal, corrected once by the exact
// remainder. __fdiv_rn gives the same bits there (checked for every float
// in that range on the H100, see divide_green_check) with a guarded slow
// path and a branch per call.
constexpr float kGreen = 0.587f;
constexpr float kDivLo = 0x1p-100f, kDivHi = 0x1p100f;

__device__ __forceinline__ float divide_green(float x, float recip) {
  const float q0 = __fmul_rn(x, recip);
  const float rem = __fmaf_rn(-q0, kGreen, x);
  return __fmaf_rn(rem, recip, q0);
}

__device__ __forceinline__ bool divide_green_ok(float x) {
  const float a = fabsf(x);
  return a == 0.0f || (a >= kDivLo && a <= kDivHi);
}

// Clamp to [0, 255] and truncate, as the twin's clamp + int cast: adding
// 2^23 rounded toward zero leaves the integer part in the low mantissa bits
// (the conversion unit's F2I runs at a quarter of the fp32 rate).
__device__ __forceinline__ uint32_t to_u8(float x, int round_mode) {
  if (round_mode) x = __fadd_rn(x, 0.5f);  // floor(x + 0.5) once clamped
  x = fminf(fmaxf(x, 0.0f), 255.0f);
  return __float_as_uint(__fadd_rz(x, 8388608.0f)) & 0xFF;
}

// Four values of one component for Y-resolution columns x0 .. x0 + 3 of a
// shared-memory pixel row: one chunk, replicated by index for fx = 2, 4.
__device__ __forceinline__ float4 load4(const float* row, int x0, int fx_log2) {
  const float4 q =
      *reinterpret_cast<const float4*>(row + chunk_at((x0 >> fx_log2) >> 2));
  if (fx_log2 == 0) return q;
  if (fx_log2 == 1)
    return (x0 & 4) ? make_float4(q.z, q.z, q.w, q.w)
                    : make_float4(q.x, q.x, q.y, q.y);
  const int i = (x0 >> 2) & 3;
  const float t = i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
  return make_float4(t, t, t, t);
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return a | (b << 8) | (c << 16) | (d << 24);
}

template <bool kApprox>
__global__ void __launch_bounds__(kThreads)
fused_plane_kernel(const Geometry g,
                   const float* __restrict__ qtab,  // [B, n_comp, 64]
                   const Basis bas, uint8_t* __restrict__ out,  // [B, 3, h_pad, w_pad]
                   int64_t h_pad, int64_t w_pad, int round_mode) {
  extern __shared__ float4 smem4[];
  float* tile_px = reinterpret_cast<float*>(smem4);  // the cell's pixels
  __shared__ float s_q[kMaxComp * 64];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int64_t mcu_row = blockIdx.y;
  const int64_t b = blockIdx.z;
  for (int i = tid; i < g.n_comp * 64; i += kThreads)
    s_q[i] = qtab[b * g.n_comp * 64 + i];
  __syncthreads();

  // 1. One thread per block: eight 16-byte loads (a block row each),
  //    dequantise, IDCT in registers, eight pixel rows to shared memory.
  for (int blk = tid; blk < g.n_blocks; blk += kThreads) {
    const int ci = comp_of(g, blk);
    const Comp& c = g.c[ci];
    const int i = blk - c.first;
    const int by = i >> c.nbx_log2;
    const int bx = i & (c.nbx - 1);
    const int16_t* src = c.ptr + b * c.rows * c.stride +
                         (mcu_row * 8 * c.v + by * 8) * c.stride +
                         static_cast<int64_t>(tile) * c.nbx * 8 + bx * 8;
    int4 raw[8];
#pragma unroll
    for (int v = 0; v < 8; ++v)
      raw[v] = __ldg(reinterpret_cast<const int4*>(src + v * c.stride));
    const float* q = s_q + ci * 64;
    float f[8][8];
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int w[4] = {raw[v].x, raw[v].y, raw[v].z, raw[v].w};
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int16_t coef = static_cast<int16_t>(
            (u & 1) ? (w[u >> 1] >> 16) : (w[u >> 1] & 0xFFFF));
        f[v][u] = __fmul_rn(static_cast<float>(coef), q[v * 8 + u]);
      }
    }
    // Both passes in registers (idct8x8.cuh), a row at a time into the
    // cell's pixels; K1a rounds the vertical pass's operands and result to
    // bf16.
    if constexpr (kApprox)
      idct8_columns_bf16(f, bas.a);
    else
      idct8_columns(f, bas.a);
    const int cols = c.nbx * 8;
    float* dst = tile_px + c.tile + by * 8 * cols;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      float s[8];
      if constexpr (kApprox)
        idct8_row_bf16(f[y], bas.a, s);
      else
        idct8_row<false>(f[y], bas.a, s);
      float* row = dst + y * cols;
      *reinterpret_cast<float4*>(row + chunk_at(2 * bx)) =
          make_float4(s[0], s[1], s[2], s[3]);
      *reinterpret_cast<float4*>(row + chunk_at(2 * bx + 1)) =
          make_float4(s[4], s[5], s[6], s[7]);
    }
  }
  __syncthreads();

  // 2. One thread per 16 pixels of a row: upsample by index, colour
  //    convert, one 16-byte store per plane.
  const int rows_y = 8 * g.v_max;
  const int64_t plane_sz = h_pad * w_pad;
  const float recip = __frcp_rn(kGreen);
  // Reference order (src/jpeg/decoder.rs:392-402), float32 constants as the
  // JAX package rounds them.
  const float kr = static_cast<float>(2.0 - 2.0 * 0.299);
  const float kb = static_cast<float>(2.0 - 2.0 * 0.114);
  const Comp& c0 = g.c[0];
  const Comp& c1 = g.c[1];
  const Comp& c2 = g.c[2];
  for (int grp = tid; grp < rows_y * (kTileW / 16); grp += kThreads) {
    const int yy = grp >> 4;
    const int x0 = (grp & 15) * 16;
    uint8_t* o = out + b * 3 * plane_sz + (mcu_row * rows_y + yy) * w_pad +
                 static_cast<int64_t>(tile) * kTileW + x0;
    const float* y_row = tile_px + c0.tile + (yy >> c0.fy_log2) * c0.nbx * 8;
    uint32_t rw[4], gw[4], bw[4];
    if (g.n_comp == 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 y = load4(y_row, x0 + 4 * k, c0.fx_log2);
        rw[k] = pack4(to_u8(__fadd_rn(y.x, 128.0f), round_mode),
                      to_u8(__fadd_rn(y.y, 128.0f), round_mode),
                      to_u8(__fadd_rn(y.z, 128.0f), round_mode),
                      to_u8(__fadd_rn(y.w, 128.0f), round_mode));
      }
      const uint4 p = make_uint4(rw[0], rw[1], rw[2], rw[3]);
      *reinterpret_cast<uint4*>(o) = p;
      *reinterpret_cast<uint4*>(o + plane_sz) = p;
      *reinterpret_cast<uint4*>(o + 2 * plane_sz) = p;
      continue;
    }
    const float* cb_row = tile_px + c1.tile + (yy >> c1.fy_log2) * c1.nbx * 8;
    const float* cr_row = tile_px + c2.tile + (yy >> c2.fy_log2) * c2.nbx * 8;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 y4 = load4(y_row, x0 + 4 * k, c0.fx_log2);
      const float4 cb4 = load4(cb_row, x0 + 4 * k, c1.fx_log2);
      const float4 cr4 = load4(cr_row, x0 + 4 * k, c2.fx_log2);
      const float ys[4] = {y4.x, y4.y, y4.z, y4.w};
      const float cbs[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
      const float crs[4] = {cr4.x, cr4.y, cr4.z, cr4.w};
      float r[4], bl[4], num[4], gr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j] = __fadd_rn(__fmul_rn(crs[j], kr), ys[j]);
        bl[j] = __fadd_rn(__fmul_rn(cbs[j], kb), ys[j]);
        num[j] = __fsub_rn(__fsub_rn(ys[j], __fmul_rn(0.114f, bl[j])),
                           __fmul_rn(0.299f, r[j]));
      }
      if (divide_green_ok(num[0]) && divide_green_ok(num[1]) &&
          divide_green_ok(num[2]) && divide_green_ok(num[3])) {
#pragma unroll
        for (int j = 0; j < 4; ++j) gr[j] = divide_green(num[j], recip);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) gr[j] = __fdiv_rn(num[j], kGreen);
      }
      uint32_t r8[4], g8[4], b8[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r8[j] = to_u8(__fadd_rn(r[j], 128.0f), round_mode);
        g8[j] = to_u8(__fadd_rn(gr[j], 128.0f), round_mode);
        b8[j] = to_u8(__fadd_rn(bl[j], 128.0f), round_mode);
      }
      rw[k] = pack4(r8[0], r8[1], r8[2], r8[3]);
      gw[k] = pack4(g8[0], g8[1], g8[2], g8[3]);
      bw[k] = pack4(b8[0], b8[1], b8[2], b8[3]);
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(rw[0], rw[1], rw[2], rw[3]);
    *reinterpret_cast<uint4*>(o + plane_sz) = make_uint4(gw[0], gw[1], gw[2], gw[3]);
    *reinterpret_cast<uint4*>(o + 2 * plane_sz) =
        make_uint4(bw[0], bw[1], bw[2], bw[3]);
  }
}

// Counts the floats x (NaN and infinity excluded) in [lo_bits, hi_bits] of
// the positive range, and their negatives, where divide_green differs from
// __fdiv_rn, and the smallest and largest such |x| as bits.
__global__ void divide_green_check(uint32_t lo_bits, uint32_t hi_bits,
                                   unsigned long long* bad, uint32_t* lo_bad,
                                   uint32_t* hi_bad) {
  const float recip = __frcp_rn(kGreen);
  for (uint64_t i = lo_bits + blockIdx.x * static_cast<uint64_t>(blockDim.x) +
                    threadIdx.x;
       i <= hi_bits; i += static_cast<uint64_t>(gridDim.x) * blockDim.x) {
    for (int sign = 0; sign < 2; ++sign) {
      const float x = __uint_as_float(static_cast<uint32_t>(i) | (sign ? 0x80000000u : 0u));
      if (__float_as_uint(divide_green(x, recip)) !=
          __float_as_uint(__fdiv_rn(x, kGreen))) {
        atomicAdd(bad, 1ull);
        atomicMin(lo_bad, static_cast<uint32_t>(i));
        atomicMax(hi_bad, static_cast<uint32_t>(i));
      }
    }
  }
}

template <bool kApprox>
cudaError_t launch_plane(const Geometry& g, const float* qtab, const Basis& bas,
                         uint8_t* out, int64_t h_pad, int64_t w_pad,
                         int round_mode, size_t smem, dim3 grid,
                         cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_plane_kernel<kApprox>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  fused_plane_kernel<kApprox><<<grid, kThreads, smem, stream>>>(
      g, qtab, bas, out, h_pad, w_pad, round_mode);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K1 (approx = 0) or K1a (approx = 1) on `stream`. Device
// pointers: planes[c] ([batch, rows[c], stride[c]] int16, contiguous,
// 16-byte aligned), qtab ([batch, n_comp, 64] f32), out ([batch, 3, h_pad,
// w_pad] u8, 16-byte aligned). Host arrays: planes, rows, stride, h, v
// (n_comp entries each) and basis (64 f32, A[u][x]; bf16-rounded values for
// K1a). Returns cudaGetLastError() after the launch (0 = launched).
int jt_fused_plane_decode(const void* const* planes, const int64_t* rows,
                          const int64_t* stride, const int32_t* h,
                          const int32_t* v, int32_t n_comp, int32_t h_max,
                          int32_t v_max, int32_t mcu_rows, const void* qtab,
                          const float* basis, void* out, int64_t batch,
                          int64_t h_pad, int64_t w_pad, int32_t round_mode,
                          int32_t approx, void* stream) {
  if (n_comp < 1 || n_comp > kMaxComp || w_pad % kTileW != 0 || batch < 1 ||
      batch > 65535 || mcu_rows < 1 || mcu_rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{};
  Basis bas;
  for (int i = 0; i < 64; ++i) bas.a[i] = basis[i];
  int blocks = 0, floats = 0;
  for (int c = 0; c < n_comp; ++c) {
    // Whole upsampling factors of 1, 2 or 4 on both axes, as K2's launcher
    // takes them.
    if (h[c] < 1 || v[c] < 1 || h_max % h[c] != 0 || v_max % v[c] != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const int fx = h_max / h[c], fy = v_max / v[c];
    if ((fx != 1 && fx != 2 && fx != 4) || (fy != 1 && fy != 2 && fy != 4))
      return static_cast<int>(cudaErrorInvalidValue);
    Comp& k = g.c[c];
    k.ptr = static_cast<const int16_t*>(planes[c]);
    k.rows = rows[c];
    k.stride = stride[c];
    k.v = v[c];
    k.nbx = kTileW / fx / 8;
    k.nbx_log2 = fx == 1 ? 5 : (fx == 2 ? 4 : 3);
    k.fx_log2 = fx == 1 ? 0 : (fx == 2 ? 1 : 2);
    k.fy_log2 = fy == 1 ? 0 : (fy == 2 ? 1 : 2);
    k.first = blocks;
    k.tile = floats;
    blocks += k.v * k.nbx;
    floats += 8 * k.v * k.nbx * 8;
  }
  for (int c = n_comp; c < kMaxComp; ++c) g.c[c].first = blocks;
  g.n_comp = n_comp;
  g.v_max = v_max;
  g.n_blocks = blocks;
  // Up to 3 x 32 x 256 floats (96 KB) when every component is 4x4: opt in
  // past 48 KB.
  const size_t smem = sizeof(float) * floats;
  dim3 grid(static_cast<unsigned>(w_pad / kTileW), static_cast<unsigned>(mcu_rows),
            static_cast<unsigned>(batch));
  const float* q = static_cast<const float*>(qtab);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      approx ? launch_plane<true>(g, q, bas, o, h_pad, w_pad, round_mode, smem,
                                  grid, st)
             : launch_plane<false>(g, q, bas, o, h_pad, w_pad, round_mode,
                                   smem, grid, st));
}

// Run divide_green_check over positive float bit patterns lo_bits ..
// hi_bits (and their negatives) on `stream`; out = [mismatches (u64),
// smallest and largest mismatching |x| bits (u32 each)], device memory,
// initialised by the caller to {0, 0xFFFFFFFF, 0}.
int jt_divide_green_check(uint32_t lo_bits, uint32_t hi_bits, void* out,
                          void* stream) {
  auto* bad = static_cast<unsigned long long*>(out);
  auto* lo_hi = reinterpret_cast<uint32_t*>(bad + 1);
  divide_green_check<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      lo_bits, hi_bits, bad, lo_hi, lo_hi + 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
