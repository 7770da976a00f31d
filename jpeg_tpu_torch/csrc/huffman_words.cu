// K4: word-column Huffman decoder for Hopper (sm_90a), in two passes.
//
// Replaces the Pallas kernel jpeg_tpu/entropy/device_kernel.py::_make_kernel
// (built by _compiled_kernel4): the v4 tier, which decodes every restart
// segment ("lane") over lane-private word columns. It keeps that kernel's
// layouts and output contract bit for bit, flagged lanes included, and none
// of its mechanics: no lockstep grid over MCUs, no select-reduce gathers, no
// 96-bit register with its `cnt <= 32` refill rule and `>= 31 bits` mask, no
// step counter (a block closes within 63 AC symbols whatever the stream, see
// huffman_common.cuh). The TPU kernel's cursor is simply the bits a lane has
// consumed, which the reader counts.
//
// - input: words [W, S] int32, lane-minor: lane l's stream is the big-endian
//   32-bit words words[i * S + l], its segment's bytes, then 0xAA fill up to
//   W words, then zeros for every word index >= W. A flagged lane can read
//   far past W (zeros often decode as a short valid code), so the reader
//   makes those zeros itself;
// - symbols, magnitudes, DC prediction, EOB / ZRL: as K3, from the same
//   host-built tables (device_huffman.kernel_tables);
// - errors: a lane stops at its first invalid prefix; that block keeps what
//   it decoded so far plus its DC predictor, later blocks are zeros. The
//   flag is set then, or when the lane consumed more than 8 bits past its
//   segment end (consumed bits > bitend + 8).
//
// Output: out [max_mcus, bpm, 64, S] int32, zigzag order, DC predicted,
// lane-minor, every element written (zeros for blocks past a lane's nblk
// and after its error block); err [S] u8. Both allocated uninitialised.
//
// The design is K3's (huffman_common.cuh holds the pass bodies):
//
// Pass 1 (boundary_pass): one thread per lane walks the lane's symbols
// through the pair table without decoding values and records, per block, its
// start bit and the DC predictor after it: 16 bytes at scratch
// [block index, lane], lane-minor, slot -1 for every block the lane does not
// decode. Bound: the latency of that serial chain (a 4K lane's ~15,500
// symbols take ~10,000 steps); the launcher gives a warp as few lanes as
// keep about two warps per scheduler, as K3's.
//
// Pass 2 (block_pass): one warp per (block index, 32 consecutive lanes). It
// reads its 32 records as 512 contiguous bytes; each thread decodes its
// lane's block from the recorded start bit into its column of a shared
// staging tile [64, 32]; the warp then writes the tile as 64 lines of 128
// contiguous bytes, each output byte once. Stream reads are scattered
// 4-byte loads (a warp's threads stand at nearby, unequal bits of
// neighbouring columns); a 4K frame's words are 1-2 MB and stay in L2.
// Bound: the output bytes.
//
// On one 4K frame (135 lanes, 51 MB out; byte bound 0.015 ms) pass 1 takes
// 1.36 ms, as K3's on the same stream, and pass 2 0.05 ms; on 8 frames 1.77
// and 0.24 ms (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py --times).

#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman_common.cuh"

namespace {

using namespace huffman;

constexpr int kRowThreads = 256;  // pass 2: eight warps per block
constexpr int kWarps = kRowThreads / 32;
constexpr int kTile = 64 * 32;    // staging tile per warp, i32

// A lane's bits, left-aligned in a 64-bit buffer, over column `col` of the
// word matrix. Bytes are counted as K3's reader counts them; a refill tops
// the buffer up to 56-63 bits from the three words loaded at the previous
// refill and loads the next three. The words are big-endian values already.
// Every word of a column lies in another cache line, which the lanes of
// other warps share, so these loads miss the L1; issued a refill ahead, they
// are not waited for (asking the L1 for lines further ahead gained nothing).
struct WordReader {
  const uint32_t* col;  // words + lane: word i at col[i * stride]
  int stride;   // S; W * S < 2^31 (the launcher checks)
  int n_words;  // W; a word index at or past it reads 0
  int pos;      // bytes moved into buf
  int cnt;      // valid bits in buf
  uint64_t buf;
  uint32_t w0, w1, w2;  // words pos / 4 .. pos / 4 + 2

  __device__ __forceinline__ uint32_t word(int i) const {
    return i < n_words ? __ldg(col + i * stride) : 0u;
  }
  __device__ __forceinline__ void fetch() {
    const int i = pos >> 2;
    const uint32_t* p = col + i * stride;
    if (i + 2 < n_words) {  // all but a column's last words, and past them
      w0 = __ldg(p);
      w1 = __ldg(p + stride);
      w2 = __ldg(p + 2 * stride);
    } else {
      w0 = word(i);
      w1 = word(i + 1);
      w2 = word(i + 2);
    }
  }
  // Bytes pos .. pos + 7 of the stream.
  __device__ __forceinline__ uint64_t window() const {
    const int sh = (pos & 3) * 8;
    return (static_cast<uint64_t>(__funnelshift_l(w1, w0, sh)) << 32) |
           __funnelshift_l(w2, w1, sh);
  }
  __device__ __forceinline__ void refill() {
    if (cnt < 43) {
      buf |= window() >> cnt;
      pos += (63 - cnt) >> 3;
      cnt |= 56;
      fetch();
    }
  }
  __device__ __forceinline__ void start(const uint32_t* column, int s, int w,
                                        int bit) {
    col = column;
    stride = s;
    n_words = w;
    // Keep the column's address and stride in registers: left alone, the
    // compiler rebuilds both from the kernel's parameters at every refill.
    asm volatile("" : "+l"(col), "+r"(stride));
    pos = bit >> 3;
    cnt = 0;
    buf = 0;
    fetch();
    refill();
    consume(bit & 7);
  }
  __device__ __forceinline__ uint32_t peek32() const {
    return static_cast<uint32_t>(buf >> 32);
  }
  __device__ __forceinline__ void consume(int n) {
    buf <<= n;
    cnt -= n;
  }
  __device__ __forceinline__ int consumed_bits() const { return pos * 8 - cnt; }
  __device__ __forceinline__ uint32_t top11() const {
    return static_cast<uint32_t>(buf >> 53);
  }
};

__global__ void __launch_bounds__(kWalkThreads)
boundary_pass(const uint32_t* __restrict__ words, int n_words, int S,
              const int32_t* __restrict__ nblk,
              const int32_t* __restrict__ bitend,
              const int32_t* __restrict__ pair, const int32_t* __restrict__ hv,
              const int32_t* __restrict__ canon,
              const int32_t* __restrict__ slots, int n_rows, int bpm,
              int lanes_per_warp, int total_blocks, int4* __restrict__ meta,
              uint8_t* __restrict__ err_out) {
  extern __shared__ uint32_t s_skip[];
  __shared__ SharedTables st;
  const Tables t = load_tables(s_skip, &st, pair, hv, canon, slots, n_rows, bpm);
  __shared__ SlotDesc s_desc[kMaxSlots];
  __shared__ int32_t s_pred[4 * kWalkThreads];
  const uint32_t tab = static_cast<uint32_t>(__cvta_generic_to_shared(s_skip));
  init_walk(s_desc, s_pred, st, tab, bpm);

  const int in_warp = threadIdx.x & 31;
  const int lane =
      (blockIdx.x * (kWalkThreads / 32) + (threadIdx.x >> 5)) * lanes_per_warp +
      in_warp;
  if (in_warp >= lanes_per_warp || lane >= S) return;
  WordReader br;
  br.start(words + lane, S, n_words, 0);
  const int n = min(nblk[lane], total_blocks);
  int4* rec = meta + lane;  // block b's record at rec[b * S]
  const int64_t stride = S;
  bool bad;
  const int blk = walk_lane(br, t, s_desc, s_pred, tab, st.dcrow[0], n, bpm,
                            lane,
                            [rec, stride](int b) { return rec + b * stride; },
                            &bad);
  // Blocks after the lane's error block, and past its nblk, are zeros.
  for (int b = blk + (bad ? 1 : 0); b < total_blocks; ++b)
    rec[b * stride] = make_int4(0, 0, lane, -1);
  err_out[lane] =
      (bad || br.consumed_bits() > static_cast<int64_t>(bitend[lane]) + 8) ? 1
                                                                           : 0;
}

__global__ void __launch_bounds__(kRowThreads)
block_pass(const uint32_t* __restrict__ words, int n_words, int S,
           const int32_t* __restrict__ skip, const int32_t* __restrict__ hv,
           const int32_t* __restrict__ canon,
           const int32_t* __restrict__ slots, int n_rows, int bpm,
           const int4* __restrict__ meta, int total_blocks,
           int32_t* __restrict__ out) {
  extern __shared__ uint32_t s_skip[];
  __shared__ SharedTables st;
  const Tables t = load_tables(s_skip, &st, skip, hv, canon, slots, n_rows, bpm);
  const int warp = threadIdx.x >> 5;
  const int tid = threadIdx.x & 31;
  int32_t* stage = reinterpret_cast<int32_t*>(s_skip + n_rows * kT11) + warp * kTile;
  int4* stage4 = reinterpret_cast<int4*>(stage);
  const int4 zero = make_int4(0, 0, 0, 0);
  const uint32_t tab = static_cast<uint32_t>(__cvta_generic_to_shared(s_skip));
  const int chunks = (S + 31) / 32;  // lane chunks per block index
  const int64_t n_tasks = static_cast<int64_t>(total_blocks) * chunks;

  for (int64_t task = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       task < n_tasks; task += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t b = task / chunks;
    const int lane = static_cast<int>(task - b * chunks) * 32 + tid;
    // Zero the warp's tile: 16 B a thread, 512 B a step.
#pragma unroll
    for (int i = 0; i < kTile / 128; ++i) stage4[i * 32 + tid] = zero;
    __syncwarp();
    const int4 m = lane < S ? __ldg(meta + b * S + lane) : make_int4(0, 0, 0, -1);
    if (m.w >= 0) {
      WordReader br;
      br.start(words + lane, S, n_words, m.x);
      decode_block<32>(br, t, tab, t.dcrow[m.w], t.acrow[m.w], m.y, stage + tid);
    }
    __syncwarp();
    // Line k of the tile is 128 contiguous bytes of the output.
    if (lane < S) {
      int32_t* dst = out + b * 64 * S + lane;
#pragma unroll 16
      for (int k = 0; k < 64; ++k)
        dst[static_cast<int64_t>(k) * S] = stage[k * 32 + tid];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Launch K4's two passes on `stream`. All pointers are device pointers:
// words [n_words, S] i32; nblk, bitend [S] i32; the skip and pair tables
// [n_rows, 2048] (pass 2's and pass 1's), huffval [n_rows, 256], canon
// [n_rows, 15] (i32) of the n_rows table rows the slots use, slots [bpm, 3]
// (component, DC row, AC row into them); scratch meta [max_mcus * bpm, S, 4]
// i32; outputs out [max_mcus, bpm, 64, S] i32 and err [S] u8, none
// initialised. Returns cudaGetLastError() after the launches (0 = launched).
int jt_huffman_words(const void* words, int32_t n_words, int32_t S,
                     const void* nblk, const void* bitend, const void* skip,
                     const void* pair, const void* huffval, const void* canon,
                     const void* slots, int32_t n_rows, int32_t bpm,
                     int32_t max_mcus, void* meta, void* out, void* err,
                     void* stream) {
  if (n_words < 2 || S < 1 || bpm < 1 || bpm > kMaxSlots || n_rows < 1 ||
      n_rows > kMaxRows || max_mcus < 0 ||
      static_cast<int64_t>(max_mcus) * bpm > INT32_MAX ||
      static_cast<int64_t>(n_words) * S > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t skip_bytes = sizeof(uint32_t) * kT11 * n_rows;
  const size_t stage_bytes = sizeof(int32_t) * kWarps * kTile;
  static int sms = 0;  // set last, once both kernels may use their memory
  if (sms == 0) {
    cudaError_t e;
    const int n_sm = sm_count(&e);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(boundary_pass,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(uint32_t) * kT11 * kMaxRows));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          block_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(sizeof(uint32_t) * kT11 * kMaxRows + stage_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    sms = n_sm;
  }
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* hv = static_cast<const int32_t*>(huffval);
  const auto* cn = static_cast<const int32_t*>(canon);
  const auto* sl = static_cast<const int32_t*>(slots);
  auto* m = static_cast<int4*>(meta);
  const int total_blocks = max_mcus * bpm;
  const int lanes_per_warp = lanes_per_warp_for(S, sms);
  const int per_block = (kWalkThreads / 32) * lanes_per_warp;
  boundary_pass<<<(S + per_block - 1) / per_block, kWalkThreads, skip_bytes,
                  s>>>(
      w, n_words, S, static_cast<const int32_t*>(nblk),
      static_cast<const int32_t*>(bitend), static_cast<const int32_t*>(pair),
      hv, cn, sl, n_rows, bpm, lanes_per_warp, total_blocks, m,
      static_cast<uint8_t*>(err));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || total_blocks == 0) return static_cast<int>(e);
  // Two blocks of eight warps per SM, each walking warp-sized tasks.
  const int64_t n_tasks = static_cast<int64_t>(total_blocks) * ((S + 31) / 32);
  const int64_t blocks_needed = (n_tasks + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(
      blocks_needed < 2 * sms ? blocks_needed : 2 * sms);
  block_pass<<<blocks, kRowThreads, skip_bytes + stage_bytes, s>>>(
      w, n_words, S, static_cast<const int32_t*>(skip), hv, cn, sl, n_rows,
      bpm, m, total_blocks, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
