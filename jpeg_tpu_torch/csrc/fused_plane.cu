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
//      chunks. The chunk index is swizzled (chunk_at) so these writes and
//      the colour stage's reads are free of bank conflicts.
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
// K6; its basis is a kernel argument (constant bank). The colour stage's
// division by 0.587 and its u8 conversion take shorter routes that give
// the same bits (see divide_green and to_u8).
//
// Bound on the H100: bytes, 0.120 ms for 8 4K frames (3 bytes of int16 in
// and 3 of u8 out per 4:2:0 pixel at 3.35 TB/s). It takes 2-3x that: the
// fp32 work, every product and sum rounded apart (no FMA), is ~1,500
// instructions a block and ~30 a pixel, and the loads, the shared-memory
// traffic and the stores, the IDCT's arithmetic and the colour stage's each
// take a comparable share of the time.
//
// K1a, the approx tier (template flag kApprox): the same cell and the same
// colour stage with the TPU kernel's idct_mode="approx" arithmetic.
// Replaces fused_plane_decoder's second compiled pallas_call
// (pallas_kernels.py:268, with Precision.DEFAULT at
// :301-302; sandwich_idct_split :160-185): the dequantised block and the
// basis rounded to bf16, the vertical pass summed in fp32, its result
// rounded to bf16, the horizontal pass summed in fp32. Here both passes run
// on the tensor cores as bf16 mma.sync with fp32 accumulation, two blocks
// of one component (2i, 2i+1 of the cell: every component holds v * nbx
// blocks with nbx in {8, 16, 32}, so pairs and groups of four never
// straddle two components or two block rows):
//   1. The cell's int16 blocks go to shared memory as they are (cp.async,
//      16 bytes a block row, 128 bytes a block; the row index is swizzled
//      by the block's low bits so that a warp's copies of one row of 32
//      neighbouring blocks hit every bank).
//   2. Per warp, four blocks at a time: one ldmatrix.x4.trans gives each
//      lane the column pairs of the coefficients that the vertical
//      product's B operand needs, dequantised in fp32 (__fmul_rn, as the
//      twin) and rounded to bf16 (RN). One m16n8k16 with the constant
//      kron(I2, A^T) as A gives both blocks' vertical pass T [16 x 8].
//   3. Its accumulator fragment is, rounded to bf16 and packed, the A
//      operand of one m16n8k8 against the basis A[u][x] (whose fragment is
//      the first product's A register): no trip through shared memory.
//   4. Eight floats a lane go to the swizzled pixel tile as float2 stores
//      (the row term of K1a's swizzle, row_swizzle, makes them free of bank
//      conflicts) and the colour stage runs as in K1.
// The fragment maps are written once, at kFragment below
// (tests/test_torch_k1a_mma.py mirrors them in NumPy).
// Not wgmma: it takes 64-row tiles per warpgroup with B in shared memory,
// and the whole IDCT is ~3 kFLOP a block (0.04 ms at the bf16 rate for 62
// 4K frames against a 0.93 ms byte bound); mma.sync's register fragments
// let step 3 reuse the accumulator in place.
// Bound: bytes, as K1. Equality with the twin (ops/idct.py::
// idct_blocks_plain(..., bf16=True)) is to a tolerance, not bit for bit:
// the products of bf16 values are exact, but the tensor core sums them in
// its own order and rounding where the twin rounds after each term, a few
// ulps of fp32 apart; rarely that moves a value of T across a bf16
// rounding point or a pixel across a u8 boundary. The TPU's MXU sums in its
// own order too: the tier is defined by docs/APPROX_QUALITY.md's gate
// against the exact tier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "idct8x8.cuh"

namespace {

constexpr int kTileW = 256;  // Y-resolution columns per cell
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxComp = 3;
constexpr int kBlockBytes = 128;  // one int16 block staged in shared memory

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
  int n_floats;  // floats of the cell's pixel tile
};

// The component of block `blk` of a cell.
__device__ __forceinline__ int comp_of(const Geometry& g, int blk) {
  return blk < g.c[1].first || g.n_comp == 1 ? 0 : (blk < g.c[2].first ? 1 : 2);
}

// Block `blk` of a cell: its component, block row and column in the cell,
// and its first coefficient in the component's plane.
struct BlockAt {
  int ci, by, bx;
  const int16_t* src;
};

__device__ __forceinline__ BlockAt block_at(const Geometry& g, int blk,
                                            int64_t b, int64_t mcu_row,
                                            int tile) {
  const int ci = comp_of(g, blk);
  const Comp& c = g.c[ci];
  const int i = blk - c.first;
  const int by = i >> c.nbx_log2;
  const int bx = i & (c.nbx - 1);
  const int16_t* src = c.ptr + b * c.rows * c.stride +
                       (mcu_row * 8 * c.v + by * 8) * c.stride +
                       static_cast<int64_t>(tile) * c.nbx * 8 + bx * 8;
  return {ci, by, bx, src};
}

// Float offset of 16-byte chunk `c` of a row of a component's pixels in
// the tile, swizzled: c ^ ((c >> 3) & 3) spreads the colour stage's reads
// (16 threads a row, 64 bytes apart) over the banks, and the row term `rs`
// (row_swizzle) spreads K1a's stores, which put four rows of one block in
// 16 lanes; K1's stores (one row of 32 blocks a warp) need none. Within a
// row `rs` is a constant, so neither stage's conflict-free pattern depends
// on the other.
__device__ __forceinline__ int chunk_at(int c, int rs) {
  return (c ^ ((c >> 3) & 3) ^ rs) * 4;
}

template <bool kApprox>
__device__ __forceinline__ int row_swizzle(int y) {
  return kApprox ? (y & 3) << 1 : 0;
}

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
// shared-memory pixel row (row term `rs`): one chunk, replicated by index
// for fx = 2, 4.
__device__ __forceinline__ float4 load4(const float* row, int x0, int fx_log2,
                                        int rs) {
  const float4 q = *reinterpret_cast<const float4*>(
      row + chunk_at((x0 >> fx_log2) >> 2, rs));
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

// K1's IDCT stage: one thread per block, eight 16-byte loads (a block row
// each), dequantise, both passes in registers (idct8x8.cuh), eight pixel
// rows to shared memory.
__device__ __forceinline__ void idct_stage_fp32(const Geometry& g,
                                                const float* s_q,
                                                const Basis& bas,
                                                float* tile_px, int64_t b,
                                                int64_t mcu_row, int tile) {
  for (int blk = threadIdx.x; blk < g.n_blocks; blk += kThreads) {
    const BlockAt at = block_at(g, blk, b, mcu_row, tile);
    const Comp& c = g.c[at.ci];
    int4 raw[8];
#pragma unroll
    for (int v = 0; v < 8; ++v)
      raw[v] = __ldg(reinterpret_cast<const int4*>(at.src + v * c.stride));
    const float* q = s_q + at.ci * 64;
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
    idct8_columns(f, bas.a);
    const int cols = c.nbx * 8;
    float* dst = tile_px + c.tile + at.by * 8 * cols;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      float s[8];
      idct8_row<false>(f[y], bas.a, s);
      float* row = dst + y * cols;
      *reinterpret_cast<float4*>(row + chunk_at(2 * at.bx, 0)) =
          make_float4(s[0], s[1], s[2], s[3]);
      *reinterpret_cast<float4*>(row + chunk_at(2 * at.bx + 1, 0)) =
          make_float4(s[4], s[5], s[6], s[7]);
    }
  }
}

// ---- K1a: the IDCT on the tensor cores ---------------------------------
//
// kFragment: the fragment maps, written here once. Lane l of a warp holds
// g = l >> 2, t = l & 3; a pair is blocks 2i, 2i+1 (F0, F1, both [v][u]);
// {x, y} is a bf16x2 register, x in the low half.
//   m16n8k16, T = kron(I2, A^T) [16 x 16] . [F0; F1] [16 (v) x 8 (u)]:
//     A: a0 = a3 = {A[2t][g], A[2t+1][g]}, a1 = a2 = 0;
//     B: b0 = {F0[2t][g], F0[2t+1][g]}, b1 = {F1[2t][g], F1[2t+1][g]};
//     C: c0, c1 = T0[g][2t], T0[g][2t+1]; c2, c3 = T1[g][2t], T1[g][2t+1].
//   m16n8k8, S = [T0; T1] [16 (y) x 8 (u)] . A [8 (u) x 8 (x)]:
//     A: a0 = {c0, c1}, a1 = {c2, c3}, rounded to bf16;
//     B: b0 = {A[2t][g], A[2t+1][g]}, the first product's a0;
//     D: d0, d1 = S0[g][2t], S0[g][2t+1]; d2, d3 = S1[g][2t], S1[g][2t+1].
// ldmatrix.x4.trans over blocks 4j .. 4j + 3: lane l gives the address of
// row (l & 7) of block 4j + (l >> 3), and receives register k =
// {B_k[2t][g], B_k[2t+1][g]} of block 4j + k: b0, b1 of the pair 4j,
// 4j + 1, then of the pair 4j + 2, 4j + 3.

// Byte offset of row v of staged block `blk`: the row index XOR the
// block's low bits, so that 8 neighbouring blocks' copies of one row land
// in 8 different 16-byte bank groups (ldmatrix reads any block's 8 rows
// from 8 different groups either way).
__device__ __forceinline__ int stage_at(int blk, int v) {
  return blk * kBlockBytes + ((v ^ (blk & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two int16 coefficients {lo, hi} of one register, dequantised in fp32 by
// their table entries and rounded to bf16.
__device__ __forceinline__ uint32_t dequant_bf16x2(uint32_t r, float q_lo,
                                                   float q_hi) {
  const float lo = static_cast<float>(static_cast<int16_t>(r & 0xFFFF));
  const float hi = static_cast<float>(static_cast<int32_t>(r) >> 16);
  return pack_bf16x2(__fmul_rn(lo, q_lo), __fmul_rn(hi, q_hi));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.0f),
        "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

__device__ __forceinline__ void mma_1688(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.0f), "f"(0.0f), "f"(0.0f),
        "f"(0.0f));
}

// Copy the cell's blocks, as int16, to `stage` (cp.async, 16 bytes a block
// row; neighbouring threads take neighbouring blocks, so a warp reads 512
// contiguous bytes an instruction). Completed by cp_async_wait.
__device__ __forceinline__ void stage_cell(const Geometry& g, char* stage,
                                           int64_t b, int64_t mcu_row,
                                           int tile) {
  const uint32_t base = smem_u32(stage);
  for (int blk = threadIdx.x; blk < g.n_blocks; blk += kThreads) {
    const BlockAt at = block_at(g, blk, b, mcu_row, tile);
    const int64_t stride = g.c[at.ci].stride;
#pragma unroll
    for (int v = 0; v < 8; ++v)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       base + stage_at(blk, v)),
                   "l"(at.src + v * stride)
                   : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K1a's IDCT stage: per warp, four staged blocks of one component at a
// time (kFragment), eight pixels a lane into the tile. The addresses are
// stage_at's and chunk_at's (as shared-memory byte addresses), with what is
// fixed for a lane or a component taken out of the loop:
//   - ldmatrix: block 4j + (l >> 3) has low bits 4 (j & 1) + (l >> 3);
//   - stores: blocks bx0 .. bx0 + 3 (bx0 a multiple of 4) fill chunks
//     2 bx0 .. 2 bx0 + 7 of a row, so chunk_at(2 (bx0 + k) + (t >> 1),
//     row_swizzle<true>(g)) is 8 bx0 + ((8k + 4 (t >> 1)) ^ (bx0 & 12) ^
//     ((g & 3) << 3)).
__device__ __forceinline__ void idct_stage_mma(const Geometry& g,
                                               const float* s_q,
                                               const Basis& bas,
                                               const char* stage,
                                               float* tile_px) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  // {A[2t][g], A[2t+1][g]}: the vertical product's a0 and a3, and the
  // horizontal product's b0 (the basis is bf16-rounded already).
  const uint32_t basis = pack_bf16x2(bas.a[2 * tq * 8 + gq],
                                     bas.a[(2 * tq + 1) * 8 + gq]);
  const uint32_t ld = smem_u32(stage) + (lane >> 3) * kBlockBytes;
  const uint32_t ld_even = ld + (((lane & 7) ^ (lane >> 3)) << 4);
  const uint32_t ld_odd = ld + (((lane & 7) ^ (4 | (lane >> 3))) << 4);
  // Byte offsets: 4 (t >> 1) and (g & 3) << 3 floats.
  const uint32_t h16 = (tq >> 1) << 4, r32 = (gq & 3) << 5;
  for (int ci = 0; ci < g.n_comp; ++ci) {
    const Comp& c = g.c[ci];
    const float q_lo = s_q[ci * 64 + 2 * tq * 8 + gq];
    const float q_hi = s_q[ci * 64 + (2 * tq + 1) * 8 + gq];
    const int cols = c.nbx * 8;
    const uint32_t lane_px =
        smem_u32(tile_px + c.tile + gq * cols + 2 * (tq & 1));
    const int j0 = c.first >> 2, j1 = j0 + ((c.v * c.nbx) >> 2);
    for (int j = j0 + ((warp - j0) & (kWarps - 1)); j < j1; j += kWarps) {
      uint32_t r[4];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
          "{%0, %1, %2, %3}, [%4];\n"
          : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
          : "r"(((j & 1) ? ld_odd : ld_even) + 4 * j * kBlockBytes)
          : "memory");
      const int i = 4 * j - c.first;
      const int by = i >> c.nbx_log2, bx0 = i & (c.nbx - 1);
      const uint32_t px = lane_px + 4 * (by * 8 * cols + 8 * bx0);
      const uint32_t w = ((bx0 & 12) << 2) ^ r32;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float t[4], s[4];
        mma_16816(t, basis, 0u, 0u, basis,
                  dequant_bf16x2(r[2 * p], q_lo, q_hi),
                  dequant_bf16x2(r[2 * p + 1], q_lo, q_hi));
        mma_1688(s, pack_bf16x2(t[0], t[1]), pack_bf16x2(t[2], t[3]), basis);
        // Row y = g, x = 2t, 2t + 1 of blocks bx0 + 2p and bx0 + 2p + 1.
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         px + ((64 * p + h16) ^ w)),
                     "f"(s[0]), "f"(s[1])
                     : "memory");
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         px + ((64 * p + 32 + h16) ^ w)),
                     "f"(s[2]), "f"(s[3])
                     : "memory");
      }
    }
  }
}

template <bool kApprox>
__global__ void __launch_bounds__(kThreads)
fused_plane_kernel(const Geometry g,
                   const float* __restrict__ qtab,  // [B, n_comp, 64]
                   const Basis bas, uint8_t* __restrict__ out,  // [B, 3, h_pad, w_pad]
                   int64_t h_pad, int64_t w_pad, int round_mode) {
  extern __shared__ float4 smem4[];
  float* tile_px = reinterpret_cast<float*>(smem4);  // the cell's pixels
  // K1a: the cell's int16 blocks, after the pixels.
  char* stage = reinterpret_cast<char*>(tile_px + g.n_floats);
  __shared__ float s_q[kMaxComp * 64];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int64_t mcu_row = blockIdx.y;
  const int64_t b = blockIdx.z;
  if constexpr (kApprox) stage_cell(g, stage, b, mcu_row, tile);
  for (int i = tid; i < g.n_comp * 64; i += kThreads)
    s_q[i] = qtab[b * g.n_comp * 64 + i];
  if constexpr (kApprox) cp_async_wait();
  __syncthreads();

  // 1. The IDCT, into the cell's pixels.
  if constexpr (kApprox)
    idct_stage_mma(g, s_q, bas, stage, tile_px);
  else
    idct_stage_fp32(g, s_q, bas, tile_px, b, mcu_row, tile);
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
    const int y_y = yy >> c0.fy_log2;
    const float* y_row = tile_px + c0.tile + y_y * c0.nbx * 8;
    const int y_rs = row_swizzle<kApprox>(y_y);
    uint32_t rw[4], gw[4], bw[4];
    if (g.n_comp == 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 y = load4(y_row, x0 + 4 * k, c0.fx_log2, y_rs);
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
    const int cb_y = yy >> c1.fy_log2, cr_y = yy >> c2.fy_log2;
    const float* cb_row = tile_px + c1.tile + cb_y * c1.nbx * 8;
    const float* cr_row = tile_px + c2.tile + cr_y * c2.nbx * 8;
    const int cb_rs = row_swizzle<kApprox>(cb_y);
    const int cr_rs = row_swizzle<kApprox>(cr_y);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 y4 = load4(y_row, x0 + 4 * k, c0.fx_log2, y_rs);
      const float4 cb4 = load4(cb_row, x0 + 4 * k, c1.fx_log2, cb_rs);
      const float4 cr4 = load4(cr_row, x0 + 4 * k, c2.fx_log2, cr_rs);
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
  g.n_floats = floats;
  // Up to 3 x 32 x 256 floats (96 KB) when every component is 4x4, and for
  // K1a up to 384 staged blocks (48 KB) more: opt in past 48 KB.
  const size_t smem =
      sizeof(float) * floats + (approx ? size_t{kBlockBytes} * blocks : 0);
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

// Registers a thread and local (spill) bytes a thread of K1 (approx = 0)
// or K1a (approx = 1), as compiled: out = [registers, local bytes].
int jt_fused_plane_attributes(int32_t approx, int32_t* out) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(
      &attr, approx ? reinterpret_cast<const void*>(fused_plane_kernel<true>)
                    : reinterpret_cast<const void*>(fused_plane_kernel<false>));
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int32_t>(attr.localSizeBytes);
  return 0;
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
