// K3: lane-per-restart-segment Huffman decoder for Hopper (sm_90a), in two
// passes.
//
// Replaces the Pallas kernel jpeg_tpu/entropy/device_window.py::
// _make_window_kernel (launched K times by _compiled_window_chain). It keeps
// that kernel's output contract bit for bit and none of its mechanics (no
// word windows, select or MXU gathers, Kronecker LUT split or VMEM frame
// model):
//
// - bit stream: the segment's bytes followed by 0xAA fill bytes forever
//   (the reference's tail padding, src/jpeg/huffman.rs:240-250);
// - symbols: 11-bit peek tables plus the canonical walk over code lengths
//   12..16 (mincode / maxcode / valptr), as the TPU kernel resolves them;
// - Table F.2 sign extension, per-lane per-component DC prediction (i32
//   wrap), EOB / ZRL with the run capped at the block end;
// - errors: a lane stops at its first invalid prefix; the block being
//   decoded keeps what it decoded so far plus its DC predictor, later blocks
//   are zero. The flag is set when that happened, or when the lane consumed
//   more than 8 bits past its segment end (cursor > bitend + 8).
//
// Output: coefficients [rows, 64] i32, zigzag order, DC predicted; lane l
// owns rows lane_out[l] .. lane_out[l] + lane_nblk[l] - 1 (MCU stream
// order); err [lanes] u8. Every output byte is written exactly once, so the
// caller allocates both uninitialised.
//
// The pass bodies (walk_lane, decode_block), the table formats and the
// byte-stream reader (ByteReader, shared with K7) live in
// huffman_common.cuh, shared with K4; this file holds the two kernels'
// frames and the launcher.
//
// Pass 1, the boundary walk (boundary_pass): one thread per lane. It decodes
// no coefficient values. Its two loops (blocks, AC symbols) are one loop
// over the state (slot in the MCU, coefficient index k), so the lanes of a
// warp advance one step per iteration whatever their block lengths and
// wait only for the lane with the most steps in total. Per step: one
// shared-memory lookup in a table built on the host (per 11-bit peek: bits
// consumed and advance of k, for two AC symbols at once where both lie
// within the peek and the first leaves the block open), one 64-bit shift,
// a refill from bytes loaded at the previous refill (ByteReader); the canonical
// walk only for codes longer than 11 bits. The table row of the next step
// is one select; the DC predictor lives in shared memory. Per block it
// stores one 16-byte record (start bit, DC predictor after the block,
// lane, slot); rows after a lane's error block get slot -1.
// Bound: the latency of that serial chain, step after step (a 4K lane's
// ~15,500 symbols take ~10,000 steps; tests/test_torch_k3_two_pass.py). A
// warp's registers share one scoreboard, so its lanes also wait for each
// other's loads: the launcher gives a warp as few lanes as keep about two
// warps per scheduler (1 lane a warp at 135 lanes, 2 at 1,080, 8 at 4,320).
//
// Pass 2, the block decode (block_pass): one thread per output row (1.56 M
// at 8 4K frames). A thread decodes its block from the recorded start bit
// with the same tables, reader and rules, into a per-warp staging area in
// shared memory (its row zeroed first); the warp then writes its 32 rows,
// 8 KB of contiguous output, with 16-byte stores. Bound: the output bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman_common.cuh"

namespace {

using namespace huffman;

constexpr int kRowThreads = 256;  // pass 2: eight warps per block
constexpr int kStage = 68;        // staging row stride in i32 (16-byte rows)
constexpr int kWarps = kRowThreads / 32;

__global__ void __launch_bounds__(kWalkThreads)
boundary_pass(const uint8_t* __restrict__ data,
              const int64_t* __restrict__ lane_start,
              const int32_t* __restrict__ lane_len,
              const int32_t* __restrict__ lane_nblk,
              const int64_t* __restrict__ lane_out, int n_lanes,
              const int32_t* __restrict__ pair,
              const int32_t* __restrict__ hv,
              const int32_t* __restrict__ canon,
              const int32_t* __restrict__ slots, int n_rows, int bpm,
              int lanes_per_warp, int4* __restrict__ meta,
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
  if (in_warp >= lanes_per_warp || lane >= n_lanes) return;
  ByteReader br;
  br.start(data + lane_start[lane], lane_len[lane], 0);
  const int nblk = lane_nblk[lane];
  int4* rec = meta + lane_out[lane];
  bool bad;
  const int blk = walk_lane(br, t, s_desc, s_pred, tab, st.dcrow[0], nblk, bpm,
                            lane, [rec](int b) { return rec + b; }, &bad);
  // Rows after a lane's error block decode to zeros.
  for (int b = blk + 1; b < nblk; ++b) rec[b] = make_int4(0, 0, lane, -1);
  const int64_t bitend = static_cast<int64_t>(br.len) * 8;
  err_out[lane] = (bad || br.consumed_bits() > bitend + 8) ? 1 : 0;
}

__global__ void __launch_bounds__(kRowThreads)
block_pass(const uint8_t* __restrict__ data,
           const int64_t* __restrict__ lane_start,
           const int32_t* __restrict__ lane_len,
           const int32_t* __restrict__ skip, const int32_t* __restrict__ hv,
           const int32_t* __restrict__ canon,
           const int32_t* __restrict__ slots, int n_rows, int bpm,
           const int4* __restrict__ meta, int64_t total_rows,
           int32_t* __restrict__ coeffs) {
  extern __shared__ uint32_t s_skip[];
  __shared__ SharedTables st;
  const Tables t = load_tables(s_skip, &st, skip, hv, canon, slots, n_rows, bpm);
  const int warp = threadIdx.x >> 5;
  const int tid = threadIdx.x & 31;
  int32_t* stage =
      reinterpret_cast<int32_t*>(s_skip + n_rows * kT11) + warp * 32 * kStage;
  int4* stage4 = reinterpret_cast<int4*>(stage);
  const int4 zero = make_int4(0, 0, 0, 0);
  const int64_t n_chunks = (total_rows + 31) / 32;
  const uint32_t tab = static_cast<uint32_t>(__cvta_generic_to_shared(s_skip));

  for (int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       chunk < n_chunks;
       chunk += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t row0 = chunk * 32;
    // Zero the warp's 32 staging rows: 16 B a thread, 512 B a step.
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int q = i * 32 + tid;
      stage4[(q >> 4) * (kStage / 4) + (q & 15)] = zero;
    }
    __syncwarp();
    const int64_t row = row0 + tid;
    const int4 m = row < total_rows ? meta[row] : make_int4(0, 0, 0, -1);
    if (m.w >= 0) {
      ByteReader br;
      br.start(data + lane_start[m.z], lane_len[m.z], m.x);
      decode_block<1>(br, t, tab, t.dcrow[m.w], t.acrow[m.w], m.y,
                      stage + tid * kStage);
    }
    __syncwarp();
    // The warp's rows are contiguous in the output: 16 B a thread.
    int4* dst = reinterpret_cast<int4*>(coeffs + row0 * 64);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int q = i * 32 + tid;
      if (row0 + (q >> 4) < total_rows)
        dst[q] = stage4[(q >> 4) * (kStage / 4) + (q & 15)];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Launch K3's two passes on `stream`. All pointers are device pointers:
// the scan bytes and lane arrays; the skip and pair tables [n_rows, 2048]
// (pass 2's and pass 1's), huffval
// [n_rows, 256], canon [n_rows, 15] (i32) of the n_rows table rows the
// slots use, slots [bpm, 3] (component, DC row, AC row); scratch meta
// [total_rows, 4] i32; outputs coeffs [total_rows, 64] i32 and err
// [n_lanes] u8, none initialised. Returns cudaGetLastError() after the
// launches (0 = launched).
int jt_huffman_lanes(const void* data, const void* lane_start,
                     const void* lane_len, const void* lane_nblk,
                     const void* lane_out, int32_t n_lanes, const void* skip,
                     const void* pair, const void* huffval, const void* canon,
                     const void* slots, int32_t n_rows, int32_t bpm,
                     int64_t total_rows, void* meta, void* coeffs, void* err,
                     void* stream) {
  if (n_lanes < 1 || bpm < 1 || bpm > kMaxSlots || n_rows < 1 ||
      n_rows > kMaxRows || total_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t skip_bytes = sizeof(uint32_t) * kT11 * n_rows;
  const size_t stage_bytes = sizeof(int32_t) * kWarps * 32 * kStage;
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
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* ls = static_cast<const int64_t*>(lane_start);
  const auto* ll = static_cast<const int32_t*>(lane_len);
  const auto* sk = static_cast<const int32_t*>(skip);
  const auto* hv = static_cast<const int32_t*>(huffval);
  const auto* cn = static_cast<const int32_t*>(canon);
  const auto* sl = static_cast<const int32_t*>(slots);
  auto* m = static_cast<int4*>(meta);
  const int lanes_per_warp = lanes_per_warp_for(n_lanes, sms);
  const int per_block = (kWalkThreads / 32) * lanes_per_warp;
  boundary_pass<<<(n_lanes + per_block - 1) / per_block, kWalkThreads,
                  skip_bytes, s>>>(
      d, ls, ll, static_cast<const int32_t*>(lane_nblk),
      static_cast<const int64_t*>(lane_out), n_lanes,
      static_cast<const int32_t*>(pair), hv, cn, sl, n_rows, bpm,
      lanes_per_warp, m, static_cast<uint8_t*>(err));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || total_rows == 0) return static_cast<int>(e);
  // Two blocks of eight warps per SM, each walking warp-sized row chunks.
  const int64_t blocks_needed = (total_rows + kRowThreads - 1) / kRowThreads;
  const int blocks = static_cast<int>(
      blocks_needed < 2 * sms ? blocks_needed : 2 * sms);
  block_pass<<<blocks, kRowThreads, skip_bytes + stage_bytes, s>>>(
      d, ls, ll, sk, hv, cn, sl, n_rows, bpm, m, total_rows,
      static_cast<int32_t*>(coeffs));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
