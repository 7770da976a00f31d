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
// reshapes. Here, as in K1 (fused_plane.cu) mirrored, each thread block owns
// one cell of the padded layout: one MCU row of one image by one 256-column
// tile (at 4:2:0, 4,096 pixels in, 64 Y and 32 chroma blocks out). Cells
// share nothing, so several are in flight on each SM.
//   1. Colour: one thread per 16 pixels of a row, for as many rows as the
//      deepest vertical box (2 at 4:2:0). One 16-byte load per channel and
//      row, each pixel read once; Y, Cb and Cr of a pixel come from the same
//      three registers. Chroma is box-averaged in registers, rows first,
//      then columns, each term scaled first and summed in ascending order.
//      The floats go to shared memory as 16-byte chunks whose index is
//      swizzled (c ^ ((c >> 3) & 3) within a row), so these writes and the
//      next stage's reads are free of bank conflicts.
//   2. Transform: one thread per 8x8 block. Eight rows into registers, the
//      vertical then the horizontal 1-D pass in registers, the product with
//      the image's reciprocal table (shared memory), rounding, clamp, and
//      eight 16-byte stores, one block row each; neighbouring threads take
//      neighbouring blocks, so a warp writes 512 contiguous bytes per row.
//
// Exactness: fp32 throughout with the dct_basis_1d basis, in the order the
// JAX kernel runs on the CPU, where XLA contracts multiply-adds: the colour
// rows as fma(k0, r, k1 * g) then fma(k2, b, .), and each DCT sum as its
// first product followed by one fma per term in index order. A product
// inside an fma is never rounded alone, so K1's shared mirrored products
// have no counterpart here: every output keeps its eight terms. Every
// operation is an explicit intrinsic (__fmul_rn / __fadd_rn / __fmaf_rn)
// and the library is built with --fmad=false, so nvcc adds no contraction
// of its own and the plain PyTorch twin
// (ops/fused_encode.py::fused_plane_encode_plain, which emulates the fma
// exactly) computes the same values. No TF32, no tensor cores. Two shorter
// routes give the twin's bits: a u8 becomes a float by placing it in the
// mantissa of 2^23 and subtracting 2^23 (exact), and the quantiser clamps
// first and then adds 1.5 x 2^23, whose sum rounds half to even at unit
// spacing and carries the int16 in its low mantissa bits (clamping to
// integer bounds and rounding commute); both skip the conversion unit,
// which runs at a fraction of the fp32 rate. The basis is a kernel
// argument, so its reads come from the constant bank.
//
// Bound on the H100: bytes, 0.120 ms for 8 4K 4:2:0 frames (3 bytes of u8
// in and 3 of int16 out per pixel at 3.35 TB/s). It takes 0.22 ms there and
// 0.033 ms for one frame (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py),
// about half the bound: the arithmetic, ~1,100 fp32 instructions a block
// (1,024 of them fma) plus ~25 a pixel, takes about as long as the bytes;
// the two stages of a cell do not overlap (one barrier), and at 128
// registers a thread four cells share an SM, so the colour stage's loads
// have 16 warps to hide behind.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 256;  // Y-resolution columns per cell
constexpr int kThreads = 128;
constexpr int kMaxComp = 3;

struct Basis {
  float a[64];  // A[u][x], row-major
};

// Per component: its plane and where its blocks sit in a cell.
struct Comp {
  int16_t* ptr;  // [B, rows, stride]
  int64_t rows, stride;
  int v;      // block rows per cell
  int nbx;    // block columns per cell (8, 16 or 32)
  int nbx_log2;
  int fx_log2, fy_log2;  // box factors 1, 2, 4
  int first;  // index of its first block in the cell
  int tile;   // float offset of its samples in the tile
};

struct Geometry {
  Comp c[kMaxComp];
  int n_comp, v_max, n_blocks;
  int patch_log2;  // rows per colour-stage thread: the largest fy
};

// The component of block `blk` of a cell.
__device__ __forceinline__ int comp_of(const Geometry& g, int blk) {
  return blk < g.c[1].first || g.n_comp == 1 ? 0 : (blk < g.c[2].first ? 1 : 2);
}

// Float offset of 16-byte chunk `c` of a shared-memory sample row (swizzled).
__device__ __forceinline__ int chunk_at(int c) { return (c ^ ((c >> 3) & 3)) * 4; }

// Byte `i` of `w` as a float: the byte in the low mantissa of 2^23, less 2^23.
__device__ __forceinline__ float byte_to_float(uint32_t w, int i) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)),
                   8388608.0f);
}

// Component c of a pixel (pallas_kernels.py:427-434), contracted as XLA's
// CPU code contracts it.
__device__ __forceinline__ float component(int c, float r, float g, float b) {
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

// The column box mean of 16 row means `a` (Y-resolution columns 16 * grp ..
// 16 * grp + 15), stored as 16 / fx samples of shared-memory row `row`:
// each term times 1/fx, summed in ascending order.
__device__ __forceinline__ void store_columns(float* row, int grp, int fx_log2,
                                              const float (&a)[16]) {
  if (fx_log2 == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(row + chunk_at(4 * grp + i)) =
          make_float4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
  } else if (fx_log2 == 1) {
    float m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      m[j] = __fadd_rn(__fmul_rn(a[2 * j], 0.5f), __fmul_rn(a[2 * j + 1], 0.5f));
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float4*>(row + chunk_at(2 * grp + i)) =
          make_float4(m[4 * i], m[4 * i + 1], m[4 * i + 2], m[4 * i + 3]);
  } else {
    float m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = __fmul_rn(a[4 * j], 0.25f);
#pragma unroll
      for (int k = 1; k < 4; ++k) s = __fadd_rn(s, __fmul_rn(a[4 * j + k], 0.25f));
      m[j] = s;
    }
    *reinterpret_cast<float4*>(row + chunk_at(grp)) =
        make_float4(m[0], m[1], m[2], m[3]);
  }
}

// Two quantised coefficients as int16 in one word: clamp, then the sum with
// 1.5 x 2^23 rounds half to even and holds the integer in its low 16 bits.
__device__ __forceinline__ uint32_t quantise2(float c0, float q0, float c1,
                                              float q1) {
  const float y0 = fminf(fmaxf(__fmul_rn(c0, q0), -32767.0f), 32767.0f);
  const float y1 = fminf(fmaxf(__fmul_rn(c1, q1), -32767.0f), 32767.0f);
  return __byte_perm(__float_as_uint(__fadd_rn(y0, 12582912.0f)),
                     __float_as_uint(__fadd_rn(y1, 12582912.0f)), 0x5410);
}

// The kernel is compiled for the usual geometries, luma at full height and
// both chroma components `1 << kChroma` rows to a sample (kLuma = 0,
// kChroma = 0, 1, 2), and once for any other (kLuma = kChroma = -1: the
// factors are read from the geometry). With constant factors the colour
// stage's row loop unrolls, so a thread's loads of all its rows are issued
// before the first is used, and the selects of the row mean fold away.
template <int kLuma, int kChroma>
__global__ void __launch_bounds__(kThreads)
fused_encode_kernel(const uint8_t* __restrict__ rgb,  // [B, n_comp, h_pad, w_pad]
                    const Geometry g,
                    const float* __restrict__ iqtab,  // [B, n_comp, 64]
                    const Basis bas, int64_t h_pad, int64_t w_pad) {
  extern __shared__ float4 smem4[];
  float* tile_px = reinterpret_cast<float*>(smem4);  // the cell's samples
  __shared__ float s_iq[kMaxComp * 64];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int64_t mcu_row = blockIdx.y;
  const int64_t b = blockIdx.z;
  for (int i = tid; i < g.n_comp * 64; i += kThreads)
    s_iq[i] = iqtab[b * g.n_comp * 64 + i];

  // 1. Colour and box mean. A thread owns 16 columns by `patch` rows; a row
  //    mean is sum_dy p[dy] * (1/fy), ascending, kept in registers until its
  //    last row arrives.
  constexpr bool kFixed = kLuma >= 0;
#define fy_log2(ci) (!kFixed ? g.c[ci].fy_log2 : ((ci) == 0 ? kLuma : kChroma))
  const int patch_log2 =
      kFixed ? (kLuma > kChroma ? kLuma : kChroma) : g.patch_log2;
  const int rows_y = 8 * g.v_max;
  const int64_t plane_sz = h_pad * w_pad;
  const uint8_t* img = rgb + b * g.n_comp * plane_sz +
                       mcu_row * rows_y * w_pad +
                       static_cast<int64_t>(tile) * kTileW;
  for (int p = tid; p < (rows_y >> patch_log2) * (kTileW / 16); p += kThreads) {
    const int grp = p & 15;
    const int y0 = (p >> 4) << patch_log2;
    float acc[kMaxComp][16] = {};
#pragma unroll(kFixed ? 4 : 1)
    for (int r = 0; r < (1 << patch_log2); ++r) {
      const int yy = y0 + r;
      const uint8_t* src = img + yy * w_pad + grp * 16;
      const uint4 r4 = __ldg(reinterpret_cast<const uint4*>(src));
      const uint32_t rw[4] = {r4.x, r4.y, r4.z, r4.w};
      float inv[kMaxComp];
      bool first[kMaxComp];
#pragma unroll
      for (int c = 0; c < kMaxComp; ++c) {
        inv[c] = 1.0f / static_cast<float>(1 << fy_log2(c));
        first[c] = (r & ((1 << fy_log2(c)) - 1)) == 0;  // y0 is a multiple
      }
      if (g.n_comp == 1) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float v = __fsub_rn(byte_to_float(rw[j >> 2], j & 3), 128.0f);
          const float t = fy_log2(0) == 0 ? v : __fmul_rn(v, inv[0]);
          acc[0][j] = first[0] ? t : __fadd_rn(acc[0][j], t);
        }
      } else {
        const uint4 g4 = __ldg(reinterpret_cast<const uint4*>(src + plane_sz));
        const uint4 b4 = __ldg(reinterpret_cast<const uint4*>(src + 2 * plane_sz));
        const uint32_t gw[4] = {g4.x, g4.y, g4.z, g4.w};
        const uint32_t bw[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float rf = byte_to_float(rw[j >> 2], j & 3);
          const float gf = byte_to_float(gw[j >> 2], j & 3);
          const float bf = byte_to_float(bw[j >> 2], j & 3);
#pragma unroll
          for (int c = 0; c < kMaxComp; ++c) {
            const float v = component(c, rf, gf, bf);
            const float t = fy_log2(c) == 0 ? v : __fmul_rn(v, inv[c]);
            acc[c][j] = first[c] ? t : __fadd_rn(acc[c][j], t);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxComp; ++c) {
        if (c < g.n_comp && ((r + 1) & ((1 << fy_log2(c)) - 1)) == 0)
          store_columns(tile_px + g.c[c].tile +
                            (yy >> fy_log2(c)) * g.c[c].nbx * 8,
                        grp, g.c[c].fx_log2, acc[c]);
      }
    }
  }
#undef fy_log2
  __syncthreads();

  // 2. One thread per block: eight sample rows from shared memory, both
  //    passes in registers, quantise, eight 16-byte stores.
  for (int blk = tid; blk < g.n_blocks; blk += kThreads) {
    const int ci = comp_of(g, blk);
    const Comp& c = g.c[ci];
    const int i = blk - c.first;
    const int by = i >> c.nbx_log2;
    const int bx = i & (c.nbx - 1);
    const int cols = c.nbx * 8;
    const float* src = tile_px + c.tile + by * 8 * cols;
    float f[8][8];
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const float* row = src + y * cols;
      const float4 lo = *reinterpret_cast<const float4*>(row + chunk_at(2 * bx));
      const float4 hi =
          *reinterpret_cast<const float4*>(row + chunk_at(2 * bx + 1));
      f[y][0] = lo.x; f[y][1] = lo.y; f[y][2] = lo.z; f[y][3] = lo.w;
      f[y][4] = hi.x; f[y][5] = hi.y; f[y][6] = hi.z; f[y][7] = hi.w;
    }
    // Vertical pass, a column at a time: t[u][x] = sum_y A[u][y] * g[y][x].
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      float col[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float s = __fmul_rn(bas.a[u * 8], f[0][x]);
#pragma unroll
        for (int y = 1; y < 8; ++y) s = __fmaf_rn(bas.a[u * 8 + y], f[y][x], s);
        col[u] = s;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) f[u][x] = col[u];
    }
    // Horizontal pass c[u][v] = sum_x t[u][x] * A[v][x], quantise, store.
    const float* q = s_iq + ci * 64;
    int16_t* dst = c.ptr + b * c.rows * c.stride +
                   (mcu_row * 8 * c.v + by * 8) * c.stride +
                   static_cast<int64_t>(tile) * cols + bx * 8;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float s[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float t = __fmul_rn(f[u][0], bas.a[v * 8]);
#pragma unroll
        for (int x = 1; x < 8; ++x) t = __fmaf_rn(f[u][x], bas.a[v * 8 + x], t);
        s[v] = t;
      }
      const float4 q0 = *reinterpret_cast<const float4*>(q + u * 8);
      const float4 q1 = *reinterpret_cast<const float4*>(q + u * 8 + 4);
      *reinterpret_cast<uint4*>(dst + u * c.stride) =
          make_uint4(quantise2(s[0], q0.x, s[1], q0.y),
                     quantise2(s[2], q0.z, s[3], q0.w),
                     quantise2(s[4], q1.x, s[5], q1.y),
                     quantise2(s[6], q1.z, s[7], q1.w));
    }
  }
}

int log2_of(int f) { return f == 1 ? 0 : (f == 2 ? 1 : (f == 4 ? 2 : -1)); }

}  // namespace

extern "C" {

// Launch K2 on `stream`. Device pointers: rgb ([batch, n_comp, h_pad, w_pad]
// u8, contiguous, 16-byte aligned), planes[c] ([batch, h_pad * v[c] / v_max,
// stride[c]] int16, contiguous, 16-byte aligned), iqtab ([batch, n_comp, 64]
// f32). Host arrays: planes, stride, h, v (n_comp entries each) and basis
// (64 f32, A[u][x]). h_pad is mcu_rows MCU rows. Returns cudaGetLastError()
// after the launch (0 = launched).
int jt_fused_encode(const void* rgb, void* const* planes, const int64_t* stride,
                    const int32_t* h, const int32_t* v, int32_t n_comp,
                    int32_t h_max, int32_t v_max, int32_t mcu_rows,
                    const void* iqtab, const float* basis, int64_t batch,
                    int64_t h_pad, int64_t w_pad, void* stream) {
  if ((n_comp != 1 && n_comp != kMaxComp) || w_pad % kTileW != 0 ||
      h_pad != static_cast<int64_t>(mcu_rows) * 8 * v_max || batch < 1 ||
      batch > 65535 || mcu_rows < 1 || mcu_rows > 65535 ||
      reinterpret_cast<uintptr_t>(rgb) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{};
  Basis bas;
  for (int i = 0; i < 64; ++i) bas.a[i] = basis[i];
  int blocks = 0, floats = 0;
  for (int c = 0; c < n_comp; ++c) {
    if (h[c] < 1 || v[c] < 1 || h_max % h[c] != 0 || v_max % v[c] != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const int fx_log2 = log2_of(h_max / h[c]), fy_log2 = log2_of(v_max / v[c]);
    if (fx_log2 < 0 || fy_log2 < 0 ||
        reinterpret_cast<uintptr_t>(planes[c]) % 16 != 0 || stride[c] % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    Comp& k = g.c[c];
    k.ptr = static_cast<int16_t*>(planes[c]);
    k.rows = h_pad * v[c] / v_max;
    k.stride = stride[c];
    k.v = v[c];
    k.nbx = (kTileW >> fx_log2) / 8;
    k.nbx_log2 = 5 - fx_log2;
    k.fx_log2 = fx_log2;
    k.fy_log2 = fy_log2;
    k.first = blocks;
    k.tile = floats;
    blocks += k.v * k.nbx;
    floats += 8 * k.v * k.nbx * 8;
    if (fy_log2 > g.patch_log2) g.patch_log2 = fy_log2;
  }
  for (int c = n_comp; c < kMaxComp; ++c) g.c[c].first = blocks;
  g.n_comp = n_comp;
  g.v_max = v_max;
  g.n_blocks = blocks;
  // The kernel for this geometry's vertical box factors.
  void (*kernel)(const uint8_t*, Geometry, const float*, Basis, int64_t,
                 int64_t) = fused_encode_kernel<-1, -1>;
  if (g.c[0].fy_log2 == 0 &&
      (n_comp == 1 || g.c[1].fy_log2 == g.c[2].fy_log2)) {
    const int f = n_comp == 1 ? 0 : g.c[1].fy_log2;
    kernel = f == 0   ? fused_encode_kernel<0, 0>
             : f == 1 ? fused_encode_kernel<0, 1>
                      : fused_encode_kernel<0, 2>;
  }
  // Up to 3 x 32 x 256 floats (96 KB) when every component is 4x4: opt in
  // past 48 KB.
  const size_t smem = sizeof(float) * floats;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>(w_pad / kTileW), static_cast<unsigned>(mcu_rows),
            static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), g, static_cast<const float*>(iqtab),
      bas, h_pad, w_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
